"""Amplitude steps of the CCSD solves per DMET iteration: the program's
counter "cc amplitude steps" (one per Jacobi-DIIS step of
solvers.cc._solve_amplitudes, each with one host read)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    n = rec.total("cc amplitude steps") if rec is not None else 0
    return n / obs["iterations"] if n else None
