"""
Readings for the limits of a cell's compared numbers, on the chip at the
cell's own size, in one process: for each seed of --seeds one job of the
program judged by the reference, for each seed of --control-seeds one
job of the control (the reference loop at float32 in the program's place)
judged the same way, and for each seed of --fault-seeds one job of the
program with each fault of --faults (perfbench/faults.py) planted.
Writes every reading, the jobs' per-iteration records and their times as
JSON to --out.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --faults dmu_search_skipped \
        --fault-seeds 7,8,9 --out chiprun_out/calibrate_<cell>.json
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

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="a folder with its own BENCHMARK.json and data"
                    " files (the tests' cell); default the benchmark's")
    args = ap.parse_args(argv)

    from perfbench import faults, harness
    from libdmet_preview_tpu_torch.utils import logger
    logger.verbose, logger.stdout = "WARNING", sys.stderr
    torch.set_num_threads(1)
    device = torch.device(args.device)
    files = harness.Files() if args.data is None else harness.Files(
        os.path.join(args.data, "BENCHMARK.json"), args.data)
    cell = files.cell(args.workload)
    cfg = files.config(cell["config"])
    mix = files.mix(cell["traffic"])
    model = harness.adapter(cfg)
    start_of = harness.protocol(mix).start_vcor
    out = {"workload": args.workload, "program": [], "control": [],
           "faults": []}
    prog = model.Program(cfg, device)

    def record(kind, seed, make):
        start = start_of(mix, prog.nparam, seed)
        sigma0 = prog.sigma_builds
        t0 = time.perf_counter()
        answer = dict(make(start), start=start)
        t1 = time.perf_counter()
        fits = []
        readings = model.judge(cfg, mix, answer, device, fits=fits)
        rec = {"seed": seed, "job_s": t1 - t0,
               "judge_s": time.perf_counter() - t1,
               "sigma_builds": prog.sigma_builds - sigma0,
               "readings": readings, "fits": fits,
               "iterations": [{k: r[k] for k in ("E", "nelec", "last_dmu",
                                                  "fit_err")}
                              for r in answer["history"]]}
        print("%s seed %d: job %.2f s, judge %.2f s, %d sigma, %s"
              % (kind, seed, rec["job_s"], rec["judge_s"],
                 rec["sigma_builds"], readings), flush=True)
        return rec

    def program(start):
        return prog.job(start, mix["filling"], mix["max_iter"])

    for seed in args.seeds:
        out["program"].append(record("program", seed, program))
    for seed in args.control_seeds:
        out["control"].append(record(
            "control", seed, lambda s: model.control(cfg, mix, s, device)))
    for name in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds:
            try:
                with faults.FAULTS[name]():
                    rec = record(name, seed, program)
            except (RuntimeError, ValueError, FloatingPointError) as e:
                # a fault that crashes the program gives no number
                rec = {"seed": seed, "error": repr(e)}
                print("%s seed %d: %r" % (name, seed, e), flush=True)
            out["faults"].append(dict(rec, fault=name))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(_plain(out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
