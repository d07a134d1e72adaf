"""
Profiling / tracing hooks (PyTorch port of
libdmet_preview_tpu/utils/profile.py): accumulating per-phase wall
clocks, each phase labelled in torch.profiler traces, and a whole-run
device trace.  Where the JAX package annotates a jax.profiler trace, the
port uses torch.profiler.record_function; a phase on a CUDA device
synchronises it before the clock is read (torch.cuda.synchronize), and
one on the CPU does not.
"""

import contextlib
import os
import time

import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.timer import _sync

_timings = {}


@contextlib.contextmanager
def phase(name, device=None):
    """Accumulating wall-clock timer for a DMET phase, labelled `name` in
    torch.profiler traces.  device: where the phase's tensors live; a
    CUDA device is synchronised before and after, so the clock holds the
    device work."""
    _sync(device)
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _sync(device)
    dt = time.perf_counter() - t0
    total, count = _timings.get(name, (0.0, 0))
    _timings[name] = (total + dt, count + 1)


def report(reset=False):
    """Log and return the accumulated phase timings."""
    out = {}
    for name, (total, count) in sorted(_timings.items()):
        log.result("phase %-24s  total %10.3f s  calls %5d  avg %8.3f ms",
                   name, total, count, total / count * 1e3)
        out[name] = {"total_s": total, "calls": count}
    if reset:
        _timings.clear()
    return out


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a torch.profiler trace of the block (CPU, and CUDA when
    available) into logdir/trace.json (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
