#!/usr/bin/env python
"""
Seconds of the CPU replays of chip_smoke.py phases 7a and 8a (one DMET
iteration of run_hub2d and of run_pdmet on the CPU at their full 40 x 40
width) alone, beside chip_smoke.DiamondRows (phase 15's short-range rows,
made by native threads at nice 19 in a background thread, as in the full
script), and beside the rows with PyTorch's CPU work on one thread.

    python scripts/replay_contention.py

Needs the card (DiamondRows builds its cells on it).  Prints one line per
(replay, condition) and the card's name and power limit.
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _timed(label, cond, fn):
    t0 = time.perf_counter()
    fn()
    print("replay contention: %-28s %-24s %.2f s"
          % (label, cond, time.perf_counter() - t0), flush=True)


def main():
    from libdmet_preview_tpu_torch.utils import logger as log
    log.verbose = "WARNING"
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    print("card: %s, host CPUs %d, torch threads %d"
          % (q.stdout.strip(), len(os.sched_getaffinity(0)),
             torch.get_num_threads()), flush=True)
    cpu = torch.device("cpu")
    cases = [("7a NIB U=6, 1 iteration",
              lambda: cs.run_hub2d(6.0, False, cpu, max_iter=1)),
             ("8a pDMET Fock, 1 iteration",
              lambda: cs.run_pdmet(False, cpu, n_fixed=1))]
    threads = torch.get_num_threads()
    for label, fn in cases:
        _timed(label, "alone", fn)
    rows = cs.DiamondRows(torch.device("cuda"))
    time.sleep(5.0)
    for label, fn in cases:
        _timed(label, "beside the rows", fn)
        torch.set_num_threads(1)
        _timed(label, "beside the rows, 1 thread", fn)
        torch.set_num_threads(threads)
    print("replay contention: rows still running: %s"
          % rows.thread.is_alive(), flush=True)
    # the rows' daemon thread is left to the process exit
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
