"""Share (%) of the FCI sigma build's roofline bound in its measured time,
from the program's own spans "fci sigma" (one per sigma application, its
(norb, nelec_a, nelec_b) among its attributes, timed by the CUDA events
the program records at its ends): the least time the card could take for
them (perfbench.roofline) over their device seconds.  Spans the card did
not time (a run on the CPU) give nothing to read."""

from collections import Counter

from perfbench import roofline, spans


def read(obs):
    rec = spans.window(obs)
    sigma = [s for s in rec.named("fci sigma") if s.device_timed] \
        if rec is not None else []
    seconds = sum(s.seconds for s in sigma)
    if not sigma or seconds <= 0.0:
        return None
    calls = Counter((s.attrs["norb"], s.attrs["nelec_a"], s.attrs["nelec_b"])
                    for s in sigma)
    bound = sum(n * roofline.bound_s(*roofline.sigma_work(*key))
                for key, n in calls.items())
    return 100.0 * bound / seconds
