"""
Leveled logger (PyTorch port of libdmet_preview_tpu/utils/logger.py).

Nine levels FATAL..DEBUG2, a module-global `verbose`, and assertion helpers
(`eassert`, `check`) used as numerical sanitizers throughout the stack.
"""

import sys
import time

from libdmet_preview_tpu_torch.utils.timer import _sync

Level = {
    "FATAL": 0,
    "ERR": 1,
    "WARNING": 2,
    "SECTION": 3,
    "RESULT": 4,
    "INFO": 5,
    "DEBUG0": 6,
    "DEBUG1": 7,
    "DEBUG2": 8,
}

verbose = "INFO"
clock = True
stdout = sys.stdout

_t0 = time.time()


def _prefix(level_name):
    if clock:
        return "%10.2f  %-7s " % (time.time() - _t0, level_name)
    return "%-7s " % level_name


def _log(level_name, msg, *args):
    if Level[level_name] <= Level[verbose]:
        try:
            text = msg % args if args else str(msg)
        except (TypeError, ValueError):
            text = " ".join([str(msg)] + [str(a) for a in args])
        stdout.write(_prefix(level_name) + text + "\n")
        stdout.flush()


def fatal(msg, *args):
    _log("FATAL", msg, *args)


def error(msg, *args):
    _log("ERR", msg, *args)


def warn(msg, *args):
    _log("WARNING", msg, *args)


warning = warn


def section(msg, *args):
    _log("SECTION", msg, *args)


def result(msg, *args):
    _log("RESULT", msg, *args)


def info(msg, *args):
    _log("INFO", msg, *args)


def debug(level, msg, *args):
    _log("DEBUG%d" % max(0, min(2, int(level))), msg, *args)


def eassert(cond, msg, *args):
    if not cond:
        _log("FATAL", msg, *args)
        raise AssertionError(msg % args if args else msg)


def check(cond, msg, *args):
    if not cond:
        warn(msg, *args)


class Timer(object):
    """Per-phase wall-clock timer.  With a CUDA `device`, the device is
    synchronised before each clock read, so the seconds hold its queued
    work (utils/timer._sync, as utils/profile.phase does)."""

    def __init__(self, name="", device=None):
        self.name = name
        self.device = device
        _sync(device)
        self.t0 = time.perf_counter()

    def elapsed(self):
        _sync(self.device)
        return time.perf_counter() - self.t0

    def log(self, what=""):
        """Log "timer <name> <what>: <s> s" at INFO; returns the seconds,
        read again after the line is written, as the JAX package does."""
        info("timer %s %s: %.4f s", self.name, what, self.elapsed())
        return self.elapsed()
