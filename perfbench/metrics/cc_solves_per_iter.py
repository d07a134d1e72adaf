"""CCSD solves per DMET iteration: the program's spans "CC amplitudes",
one per amplitude solve of solvers.cc (one per trial dmu of the
chemical-potential search)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    n = len(rec.named("CC amplitudes")) if rec is not None else 0
    return n / obs["iterations"] if n else None
