"""
Synchronised stage timer for the embedding path.

    with timer.recording() as seconds:
        ConstructImpHam(...)
    seconds   # {"bath": [s], "ERI rotation": [s], ...}

Off by default, and then stage() does nothing.  While recording, each
stage synchronises its device before and after the block and appends the
host-clock seconds between the two to the list under its name.
"""

import contextlib
import time

import torch

_seconds = None


@contextlib.contextmanager
def recording():
    """Record the stages run inside the block; yields {name: [seconds]}."""
    global _seconds
    outer, _seconds = _seconds, {}
    try:
        yield _seconds
    finally:
        _seconds = outer


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name, device=None):
    """Time the block as stage `name` on `device` while recording."""
    if _seconds is None:
        yield
        return
    record = _seconds
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    record.setdefault(name, []).append(time.perf_counter() - t0)
