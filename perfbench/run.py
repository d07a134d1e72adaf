"""
The benchmark of libdmet_preview_tpu_torch on one NVIDIA GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets the cell up, runs its traffic mix's protocol for --seconds (the
closed_jobs protocol: rounds of DMET jobs, the window ending with the
round in flight), has the plain reference judge an answer of the window,
and prints the numbers it compared (stderr, last lines) and one JSON
result line (stdout, last line).  --trace 1 measures the per-layer
metrics instead of the end-to-end ones.  Exits non-zero,
with no result, without enough CUDA devices or when JAX or the JAX
package is loaded once the window has closed.
"""

import os
import sys
import time


def _process_age():
    """Seconds since this process started (from /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread per library: the host work is many small operations;
# every cache of the run at a fixed place inside the checkout
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                                  "torch_extensions")
# the checkout's root, not this folder, leads the import path
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    files = harness.Files()
    chips = files.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("needs %d CUDA device(s); found %d" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from libdmet_preview_tpu_torch.utils import logger
    logger.verbose, logger.stdout = "WARNING", sys.stderr

    result = harness.run_cell(files, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    if result is None:
        return 1
    for key, c in result["checks"].items():
        print("check %-8s %.6e  limit %.6e" % (key, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
