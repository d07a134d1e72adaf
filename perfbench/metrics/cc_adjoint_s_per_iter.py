"""Seconds per DMET iteration in the response densities of solvers.cc: the
Lambda (adjoint) solve and the vector-Jacobian products around it: the
program's spans "CC gradient (adjoint and vjp inside)", timed by the
CUDA events at their ends (host seconds on the CPU)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    parts = rec.named("CC gradient (adjoint and vjp inside)") \
        if rec is not None else []
    if not parts:
        return None
    return sum(s.seconds for s in parts) / obs["iterations"]
