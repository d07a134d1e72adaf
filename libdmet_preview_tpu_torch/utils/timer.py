"""
The port's span-and-counter recorder: where a run's host and device time
go, at no cost when it is off.

How to record a run:

    from libdmet_preview_tpu_torch.utils import timer
    with timer.recording() as seconds:
        run_dmet(lattice, vcor, config)
    seconds["vcor fit"]            # [seconds of each "vcor fit" span]
    rec = timer.last()             # the same Recording: spans and counters
    rec.named("mu step")           # the Span objects of one name
    rec.total(timer.READS, within="vcor fit")   # host reads in the fit
    rec.read_seconds(within="vcor fit")         # host seconds they blocked

and, for a timeline, utils.profile.device_trace(logdir) around the same
block: it writes torch.profiler's events and the program's spans into one
Chrome trace, logdir/trace.json, on one time base (open it in Perfetto).

Spans.  A `stage(name, device, **attrs)` block run while a recording is
open is a Span: its name; its parent (the innermost span open when it
began); the DMET job and iteration it belongs to (`job=` and `iteration=`
given to run_dmet's "dmet iteration" span, inherited by every span below
it); its other attributes; its host start and end, by time.time_ns(), the
clock torch.profiler stamps its events with; and, on a CUDA device, a pair
of timing events recorded on the current stream at entry and exit.

Nothing synchronises the device while a recording is open.  Its spans'
events are resolved when it closes, with one torch.cuda.synchronize per
device: the yielded {name: [seconds]} is filled then, with each span's
device seconds between its two events (the host clock's seconds for a span
on the CPU or with no device).  Read it after the block.

Counters.  count(name, n) adds n to the innermost open span (to the
recording itself outside any span).  to_host(x, read) reads a tensor to
the host; while recording it also counts one READS on the innermost span
and adds the seconds the host was blocked in the read to its read_s.

Recordings nest: a span belongs to every recording open when it began, and
each recording resolves its own at its close.  last() is the most recently
closed outermost recording; it is kept until the next one closes.

With no recording open, stage, count and to_host cost one test of a
module global.  The recorder is per process and not thread-safe.
"""

import contextlib
import itertools
import os
import time

import torch

READS = "host reads"

_rec = None       # the innermost open Recording; None: the recorder is off
_span = None      # the innermost open Span
_last = None      # the last closed outermost Recording
_totals = {}      # {name: [seconds, spans]} over the closed outermost ones
_jobs = itertools.count()


class Span(object):
    """One stage block.  t0 / t1: host start and end (time.time_ns());
    seconds: device seconds between its CUDA events, or host seconds
    (set when its recording closes); counts: {counter: n} counted inside
    it and not inside a child; read_s: host seconds blocked in those
    reads."""

    __slots__ = ("name", "parent", "job", "iteration", "attrs", "t0", "t1",
                 "events", "device_timed", "seconds", "counts", "read_s")

    def __init__(self, name, parent, job, iteration, attrs):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.job, self.iteration = job, iteration
        self.t0 = self.t1 = self.events = self.seconds = None
        self.device_timed = False
        self.counts = {}
        self.read_s = 0.0

    @property
    def host_s(self):
        return (self.t1 - self.t0) * 1e-9

    def inside(self, name):
        """Whether this span or one of its ancestors is called `name`."""
        s = self
        while s is not None:
            if s.name == name:
                return True
            s = s.parent
        return False


class Recording(dict):
    """{name: [seconds]} of one recording (filled at its close), with its
    spans in the order they began, the counts and read seconds outside any
    span (counts, read_s), and sums over the spans."""

    def __init__(self, outer):
        super().__init__()
        self.outer = outer
        self.spans = []
        self.counts = {}
        self.read_s = 0.0

    def named(self, name):
        return [s for s in self.spans if s.name == name]

    def _within(self, within):
        if within is None:
            return self.spans
        return [s for s in self.spans if s.inside(within)]

    def total(self, counter, within=None):
        """Counts of `counter` in the spans inside a span called `within`
        (itself included), or in the whole recording."""
        n = sum(s.counts.get(counter, 0) for s in self._within(within))
        return n + (self.counts.get(counter, 0) if within is None else 0)

    def read_seconds(self, within=None):
        """Host seconds blocked in to_host reads, as total() counts."""
        t = sum(s.read_s for s in self._within(within))
        return t + (self.read_s if within is None else 0.0)

    def host_seconds(self, name):
        """Host-clock seconds of the spans called `name`."""
        return sum(s.host_s for s in self.named(name))

    def chrome_events(self, base_ns=0):
        """The spans as Chrome-trace complete events on one track of this
        process, their times in microseconds from base_ns on the
        time.time_ns() clock (a torch.profiler trace's
        baseTimeNanoseconds)."""
        pid, tid = os.getpid(), 0
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": "program spans"}}]
        for s in self.spans:
            if s.t1 is None:
                continue
            args = dict(s.attrs, job=s.job, iteration=s.iteration,
                        seconds=s.seconds, device_timed=s.device_timed,
                        read_s=s.read_s, **s.counts)
            out.append({"ph": "X", "cat": "program span", "name": s.name,
                        "pid": pid, "tid": tid, "ts": (s.t0 - base_ns) / 1e3,
                        "dur": (s.t1 - s.t0) / 1e3, "args": args})
        return out


def _resolve(rec):
    """Each closed span's seconds, with one synchronize per device that
    holds unresolved events; then the {name: [seconds]} view."""
    pending = [s for s in rec.spans if s.events is not None
               and s.t1 is not None]
    for index in {s.events[0].index for s in pending}:
        torch.cuda.synchronize(index)
    for s in pending:
        _, e0, e1 = s.events
        s.seconds = e0.elapsed_time(e1) * 1e-3
        s.events = None
    for s in rec.spans:
        if s.t1 is None:
            continue
        if s.seconds is None:
            s.seconds = s.host_s
        rec.setdefault(s.name, []).append(s.seconds)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block.  Yields its Recording,
    a {name: [seconds]} filled when the block ends."""
    global _rec, _last
    rec = Recording(_rec)
    _rec = rec
    try:
        yield rec
    finally:
        _rec = rec.outer
        _resolve(rec)
        if rec.outer is None:
            _last = rec
            for s in rec.spans:
                if s.seconds is not None:
                    tot = _totals.setdefault(s.name, [0.0, 0])
                    tot[0] += s.seconds
                    tot[1] += 1


def last():
    """The most recently closed outermost Recording, or None."""
    return _last


def is_recording():
    return _rec is not None


def totals(reset=False):
    """{name: (seconds, spans)} summed over the outermost recordings
    closed since the last reset."""
    out = {k: tuple(v) for k, v in _totals.items()}
    if reset:
        _totals.clear()
    return out


def next_job():
    """A new job id, for the outermost span of one job (run_dmet)."""
    return next(_jobs)


@contextlib.contextmanager
def stage(name, device=None, **attrs):
    """Record the block as a span `name` on `device` while recording.
    attrs: job= and iteration= (inherited from the parent span when not
    given) and any small attributes, kept on the span."""
    if _rec is None:
        yield
        return
    span = _open(name, device, attrs)
    try:
        yield
    finally:
        _close(span)


def _open(name, device, attrs):
    global _span
    parent = _span
    job = attrs.pop("job", None if parent is None else parent.job)
    iteration = attrs.pop("iteration",
                          None if parent is None else parent.iteration)
    span = Span(name, parent, job, iteration, attrs)
    r = _rec
    while r is not None:
        r.spans.append(span)
        r = r.outer
    _span = span
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(torch.cuda.current_stream(dev))
            span.events = (dev, e0, None)
            span.device_timed = True
    # the host stamps leave the span's own events out
    span.t0 = time.time_ns()
    return span


def _close(span):
    global _span
    span.t1 = time.time_ns()
    if span.events is not None:
        dev, e0, _ = span.events
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(torch.cuda.current_stream(dev))
        span.events = (dev, e0, e1)
    _span = span.parent


def _target():
    return _rec if _span is None else _span


def count(name, n=1):
    """Add n to counter `name` of the innermost open span, while
    recording."""
    if _rec is None:
        return
    counts = _target().counts
    counts[name] = counts.get(name, 0) + n


def _numpy(x):
    return x.cpu().numpy()


def to_host(x, read=_numpy):
    """read(x): a device-to-host read of tensor x (x.cpu().numpy() by
    default; float, bool or torch.Tensor.tolist as given).  While
    recording, one READS and the seconds it blocked the host go to the
    innermost open span."""
    if _rec is None:
        return read(x)
    t0 = time.time_ns()
    out = read(x)
    dt = (time.time_ns() - t0) * 1e-9
    target = _target()
    target.counts[READS] = target.counts.get(READS, 0) + 1
    target.read_s += dt
    return out


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
