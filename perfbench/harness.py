"""
The harness: finds a cell's configuration, traffic mix, limits and
metric readers by name (BENCHMARK.json and the files beside it), sets
the program up, measures the window, reduces the trace of a traced run,
has the reference judge an answer of the window, and returns the result.

A cell's files:
    configs/<config>.json   the configuration as it is run; "model" names
                            its adapter, models/<model>.py (the program's
                            side: jobs, counters, spans; and the judge)
    traffic/<mix>.json      the mix; "protocol" names the module that runs
                            it, protocols/<protocol>.py
    limits/<cell>.json      the limit of each number the reference compares
    metrics/<metric>.py     one reader per metric, end-to-end or per-layer,
                            over the run's observations: window_s,
                            setup_s, peak_window_bytes, busy_s, the
                            protocol's work counts, the adapter's counters
                            and its traced readings
The harness itself names no model, protocol, counter or metric.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import tracing

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "libdmet_preview_tpu")


class Files(object):
    """BENCHMARK.json and the data files of its cells under `root`."""

    def __init__(self, bench=REPO / "BENCHMARK.json", root=PKG):
        with open(bench) as f:
            self.bench = json.load(f)
        self.root = Path(root)

    def _json(self, *parts):
        with open(self.root.joinpath(*parts)) as f:
            return json.load(f)

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %s in the benchmark" % name)

    def config(self, name):
        return self._json("configs", name + ".json")

    def mix(self, name):
        mix = self._json("traffic", name + ".json")
        protocol(mix).check(mix)
        return mix

    def limits(self, cell):
        return self._json("limits", cell + ".json")

    def metrics(self, kind, cell):
        """The cell's entries of 'end_to_end' or 'per_layer'."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]


def protocol(mix):
    """The module protocols/<protocol>.py that runs the mix."""
    return importlib.import_module("perfbench.protocols." + mix["protocol"])


def adapter(cfg):
    """The module models/<model>.py of the configuration."""
    return importlib.import_module("perfbench.models." + cfg["model"])


def reader(name):
    """The read function of metrics/<name>.py."""
    path = PKG / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Top-level names of the loaded modules that the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _read_metrics(files, kind, name, obs):
    out = {}
    for m in files.metrics(kind, name):
        value = reader(m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(files, name, seed, seconds, trace, device, t_start,
             log=sys.stderr):
    """One run of cell `name`.  Returns the result dict, or None when a
    forbidden module is loaded once the window has closed."""
    cell = files.cell(name)
    cfg = files.config(cell["config"])
    mix = files.mix(cell["traffic"])
    limits = files.limits(name)
    model, proto = adapter(cfg), protocol(mix)
    cuda = device.type == "cuda"

    # set-up: the program, then the protocol's warm-up, which runs every
    # shape and kernel of the cell's window
    prog = model.Program(cfg, device)
    state = proto.prepare(prog, mix, seed)
    proto.warm(prog, mix, state)
    _sync(device)
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prog.reset_counters()
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            inst = stack.enter_context(prog.instrument(device))
            # the device's activity alone: recording every host operation
            # of a window slows the host by half
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]))
        t0 = time.perf_counter()
        answers = proto.run(prog, mix, state, seconds)
        _sync(device)
        window_s = time.perf_counter() - t0
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0

    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: %s" % ", ".join(found), file=log)
        return None

    obs = {"window_s": window_s, "setup_s": setup_s,
           "peak_window_bytes": peak_window, "busy_s": 0.0}
    obs.update(proto.work(answers))
    obs["counters"] = prog.counters()
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(max(peak_setup,
                                                    peak_window))}
    result = {"correct": None, "attempted": len(answers), "failed": 0}
    if trace:
        busy_s, breakdown = tracing.reduce(
            prof.profiler.kineto_results.events())
        obs["busy_s"] = busy_s
        obs.update(inst.read())
        dev.update(busy_s=busy_s, window_s=window_s)
    result["metrics"] = _read_metrics(
        files, "per_layer" if trace else "end_to_end", name, obs)
    result["device"] = dev
    if trace:
        result["breakdown"] = breakdown
    print("cell %s seed %d: %s, counters %s, in %.3f s of window, set-up"
          " %.3f s; card %s"
          % (name, seed, proto.work(answers), obs["counters"], window_s,
             setup_s, _power_limit() if cuda else "none"), file=log)

    # the judge: the program's state freed, the peak already read
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    answer, sample = proto.judged(answers, seed)
    readings = model.judge(cfg, mix, answer, device, sample)
    checks = {}
    for key, value in readings.items():
        checks[key] = {"value": value, "limit": limits[key]["limit"]}
    result["correct"] = bool(all(np.isfinite(c["value"])
                                 and c["value"] <= c["limit"]
                                 for c in checks.values()))
    result["failed"] = 0 if result["correct"] else 1
    k = next(i for i, a in enumerate(answers) if a is answer)
    print("reference judged answer %d of %d (at %s) in %.3f s"
          % (k, len(answers), sample,
             time.perf_counter() - t_ref), file=log)
    result["checks"] = checks
    return result
