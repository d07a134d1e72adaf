#!/usr/bin/env python
"""
Run every example of the PyTorch port (examples/torch/*.py) once, each in
a fresh process, and print its wall time and its last lines.

    python scripts/run_examples_torch.py [--device cuda|cpu] [NAME ...]

NAME filters by prefix (e.g. 00 06).  The card's name and power limit
(nvidia-smi) are printed first when --device is cuda.  Exits non-zero if
an example fails.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tail", type=int, default=6)
    ap.add_argument("names", nargs="*")
    a = ap.parse_args()
    if a.device.startswith("cuda"):
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True)
        print("card: %s" % q.stdout.strip(), flush=True)
    failed = []
    for f in sorted(os.listdir(EXAMPLES)):
        if not f.endswith(".py") or (a.names and not any(
                f.startswith(n) for n in a.names)):
            continue
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.join(EXAMPLES, f),
                            "--device", a.device], cwd=REPO,
                           capture_output=True, text=True)
        sec = time.perf_counter() - t0
        lines = [ln for ln in p.stdout.splitlines()
                 if " RESULT " not in ln and " INFO " not in ln]
        print("=== %s: %.1f s, rc %d" % (f, sec, p.returncode), flush=True)
        for ln in lines[-a.tail:]:
            print("    " + ln)
        if p.returncode != 0:
            failed.append(f)
            print(p.stderr[-3000:])
    if failed:
        print("failed: %s" % failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
