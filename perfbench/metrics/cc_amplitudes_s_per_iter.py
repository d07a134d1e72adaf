"""Seconds per DMET iteration in the amplitude fixed point of solvers.cc
(Jacobi steps with DIIS on the card, one host read a step): the
program's spans "CC amplitudes", timed by the CUDA events at their ends
(host seconds on the CPU)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    parts = rec.named("CC amplitudes") if rec is not None else []
    if not parts:
        return None
    return sum(s.seconds for s in parts) / obs["iterations"]
