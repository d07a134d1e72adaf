"""Applications of the CCSD adjoint (Lambda) operator per DMET iteration:
the program's counter "cc adjoint matvecs" (one vector-Jacobian product
of the residual each, solvers.cc._solve_adjoint)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    n = rec.total("cc adjoint matvecs") if rec is not None else 0
    return n / obs["iterations"] if n else None
