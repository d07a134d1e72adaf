"""The coupled-cluster solver's counters and its guard against non-finite
amplitudes (libdmet_preview_tpu_torch only, on the CPU): each counter of
utils.timer equals the steps its loop ran, and a solve whose amplitudes
end non-finite raises, naming the cause, where it used to hand NaN
densities to the dmu search."""

import numpy as np
import pytest
import torch

from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.solvers import cc, scf
from libdmet_preview_tpu_torch.utils import logger, timer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _quiet_one_thread():
    n, verbose = torch.get_num_threads(), logger.verbose
    torch.set_num_threads(1)
    logger.verbose = "WARNING"
    yield
    torch.set_num_threads(n)
    logger.verbose = verbose


def _integral(h, g):
    """An unrestricted Integral with one ERI block for the three spin
    pairs."""
    g = torch.as_tensor(np.asarray([g, g, g]))
    return Integral(h.shape[-1], False, False, 0.0,
                    {"cd": torch.as_tensor(h)}, {"ccdd": g})


def _hubbard_ring(n, U, seed):
    """A ring of n sites with hopping -1, on-site U and a small seeded
    spin-dependent field: an unrestricted embedding-sized problem."""
    rng = np.random.default_rng(seed)
    t = np.zeros((n, n))
    for i in range(n):
        t[i, (i + 1) % n] = t[(i + 1) % n, i] = -1.0
    h = np.asarray([t + np.diag(0.3 * rng.standard_normal(n))
                    for _ in range(2)])
    g = np.zeros((n,) * 4)
    for i in range(n):
        g[i, i, i, i] = U
    return h, g


@pytest.mark.parametrize("n, nelec", [(4, 4), (6, 4)])
def test_each_counter_equals_the_steps_of_its_loop(n, nelec):
    h, g = _hubbard_ring(n, 2.0, n + nelec)
    solver = cc.CCSD(restricted=False, tol=1e-9, device=CPU)
    with timer.recording():
        solver.run(_integral(h, g), nelec=nelec)
    rec = timer.last()
    mf = solver.scfsolver
    expected = {"cc amplitude steps": cc._solve_amplitudes.last["iterations"],
                "cc adjoint matvecs": cc._solve_adjoint.last["matvecs"],
                "scf roothaan steps": mf.cycles,
                "scf rotation steps": sum(mf.oo_evaluations)}
    for name, steps in expected.items():
        assert steps > 0, name
        assert rec.total(name) == steps, name
    # each inside the span of its stage
    assert rec.total("cc amplitude steps", within="CC amplitudes") \
        == expected["cc amplitude steps"]
    assert rec.total("cc adjoint matvecs", within="CC adjoint") \
        == expected["cc adjoint matvecs"]
    assert rec.total("scf rotation steps", within="CC reference SCF") \
        == expected["scf rotation steps"]


def test_the_counters_are_off_without_a_recording():
    h, g = _hubbard_ring(4, 2.0, 1)
    with timer.recording():
        pass
    solver = cc.CCSD(restricted=False, tol=1e-9, device=CPU)
    solver.run(_integral(h, g), nelec=4)
    assert timer.last().total("cc amplitude steps") == 0
    assert solver.scfsolver.cycles > 0


def test_non_finite_amplitudes_raise_and_name_the_cause():
    """Four degenerate, non-interacting orbitals: every orbital-energy
    denominator is 0, the first amplitudes are 0 / 0, and the solve stops
    at its first non-finite step."""
    n = 4
    ham = _integral(np.zeros((2, n, n)), np.zeros((n,) * 4))
    solver = cc.CCSD(restricted=False, tol=1e-9, device=CPU)
    with pytest.raises(RuntimeError, match="the amplitudes diverged"):
        solver.run(ham, nelec=2)
    assert solver.scfsolver.converged
    assert cc._solve_amplitudes.last["iterations"] == 1
    assert not np.isfinite(cc._solve_amplitudes.last["max|R|"])


def test_an_unconverged_reference_is_named(monkeypatch):
    n = 4
    ham = _integral(np.zeros((2, n, n)), np.zeros((n,) * 4))
    hf = scf.SCF.HF

    def unconverged(self, *a, **k):
        out = hf(self, *a, **k)
        self.converged = False
        return out
    monkeypatch.setattr(scf.SCF, "HF", unconverged)
    with pytest.raises(RuntimeError, match="reference SCF did not converge"):
        cc.CCSD(restricted=False, device=CPU).run(ham, nelec=2)


def test_a_finite_solve_is_unchanged():
    h, g = _hubbard_ring(6, 2.0, 3)
    solver = cc.CCSD(restricted=False, tol=1e-10, device=CPU)
    rdm, E = solver.run(_integral(h, g), nelec=6)
    assert np.isfinite(E) and bool(torch.isfinite(rdm).all())
    assert abs(float(rdm.diagonal(dim1=1, dim2=2).sum()) - 6.0) < 1e-8
