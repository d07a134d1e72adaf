"""
The window's length against its spread: sets a cell up as a run does,
then times --rounds windows of one round each back to back in the one
process, and prints one JSON line with each round's seconds and DMET
iterations.  Over several processes it tells whether a window of more
rounds would spread less (rounds that vary within a process) or not
(processes that differ as a whole).

    python3 perfbench/windows.py --workload <cell> --seed <n> --rounds 2
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="a folder with its own BENCHMARK.json and data"
                    " files (the tests' cell); default the benchmark's")
    args = ap.parse_args(argv)

    from perfbench import harness
    from libdmet_preview_tpu_torch.utils import logger
    logger.verbose, logger.stdout = "WARNING", sys.stderr
    torch.set_num_threads(1)
    device = torch.device(args.device)
    files = harness.Files() if args.data is None else harness.Files(
        os.path.join(args.data, "BENCHMARK.json"), args.data)
    cell = files.cell(args.workload)
    cfg = files.config(cell["config"])
    mix = files.mix(cell["traffic"])
    proto = harness.protocol(mix)
    prog = harness.adapter(cfg).Program(cfg, device)
    state = proto.prepare(prog, mix, args.seed)
    proto.warm(prog, mix, state)
    harness._sync(device)
    rounds = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        answers = proto.run(prog, mix, state, 0.0)
        harness._sync(device)
        rounds.append({"seconds": time.perf_counter() - t0,
                       "iterations": proto.work(answers)["iterations"]})
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
