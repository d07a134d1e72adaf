"""Energy evaluations of the embedded UHF's orbital-rotation minimization
per DMET iteration: the program's counter "scf rotation steps" (one per
call of the scipy BFGS's function in solvers.scf.SCF._oo_minimize, each
an autograd gradient and a host read)."""

from perfbench import spans


def read(obs):
    rec = spans.window(obs)
    n = rec.total("scf rotation steps") if rec is not None else 0
    return n / obs["iterations"] if n else None
