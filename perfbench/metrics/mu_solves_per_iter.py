"""Impurity solves per DMET iteration under the chemical-potential search:
the program's spans "mu step", one per MuSolver solve at a trial dmu."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    n = len(rec.named("mu step")) if rec is not None else 0
    return n / obs["iterations"] if n else None
