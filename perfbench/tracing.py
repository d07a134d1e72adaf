"""
Reduction of a torch.profiler trace of the measured window, read from the
profiler's raw events (the profiler's own event tree is not built: it
takes minutes for a window of DMET jobs): the device's busy seconds (the
union of the device events' time ranges), the device operations that took
most time, and the longest idle gaps of the device by what the host was
doing then (the innermost host-side event, such as a CUDA runtime call,
running at the gap's middle).
"""

import bisect
from collections import defaultdict


def _union(spans):
    """Busy seconds and the gaps [(start, end)] of sorted (start, end)
    ranges in microseconds."""
    busy, end, gaps = 0.0, None, []
    for t0, t1 in spans:
        if end is None or t0 >= end:
            if end is not None and t0 > end:
                gaps.append((end, t0))
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy * 1e-6, gaps


def reduce(events, top=10, labelled=400):
    """events: the profiler's raw events (profile.profiler.kineto_results
    .events()).  Returns (busy_s, breakdown)
    with breakdown = {"device_ops": [[name, s]], "idle_gaps": [[what the
    host ran, s]]}, each at most `top` long; the `labelled` longest gaps
    are named."""
    from torch.autograd import DeviceType
    dev, host = [], []
    by_name = defaultdict(float)
    for ev in events:
        t0 = ev.start_ns() * 1e-3
        t1 = t0 + ev.duration_ns() * 1e-3
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            dev.append((t0, t1))
            by_name[ev.name()] += (t1 - t0) * 1e-6
        elif kind == DeviceType.CPU:
            host.append((t0, t1, ev.name()))
    dev.sort()
    busy, gaps = _union(dev)
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:labelled]:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name, best = "host, no traced call", None
        for j in range(i, max(i - 5000, -1), -1):
            h0, h1, hname = host[j]
            if h1 >= mid and (best is None or h0 > best):
                name, best = hname, h0
                break
        idle[name] += (g1 - g0) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return busy, {"device_ops": [[k, v] for k, v in ops],
                  "idle_gaps": [[k, v] for k, v in gap_list]}
