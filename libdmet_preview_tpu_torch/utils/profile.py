"""
Profiling / tracing hooks (PyTorch port of
libdmet_preview_tpu/utils/profile.py) over the port's one recorder,
utils.timer: a phase is a timer span labelled in torch.profiler traces,
report() gives the recorder's totals, and device_trace() writes the
profiler's events and the program's spans into one Chrome trace.  Where
the JAX package annotates a jax.profiler trace, the port uses
torch.profiler.record_function.  Nothing here synchronises the device
while a recording is open (see utils.timer).
"""

import contextlib
import json
import os

import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils import timer


@contextlib.contextmanager
def phase(name, device=None):
    """A timer span `name` on `device`, labelled `name` in torch.profiler
    traces.  Outside any recording the phase records itself (one
    recording of its own), so report() sees every phase."""
    with contextlib.ExitStack() as stack:
        if not timer.is_recording():
            stack.enter_context(timer.recording())
        stack.enter_context(timer.stage(name, device))
        stack.enter_context(torch.profiler.record_function(name))
        yield


def report(reset=False):
    """Log and return the recorder's totals per span name (seconds: as
    utils.timer resolves them) since the last reset."""
    out = {}
    for name, (total, count) in sorted(timer.totals(reset).items()):
        log.result("phase %-24s  total %10.3f s  calls %5d  avg %8.3f ms",
                   name, total, count, total / count * 1e3)
        out[name] = {"total_s": total, "calls": count}
    return out


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a torch.profiler trace of the block (CPU, and CUDA when
    available) and record the program's spans in it: logdir/trace.json
    (Chrome trace format) holds the profiler's events and, on the same
    time base, one track "program spans" of this process."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with timer.recording() as rec:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(
        rec.chrome_events(int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
