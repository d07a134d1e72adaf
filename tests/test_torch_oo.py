"""
The PyTorch port's orbital-optimized solvers (OOCCD, OOMP2 of
libdmet_preview_tpu_torch/solvers/oo.py) against the JAX package's on the
systems of tests/test_oo.py, their exact-FCI oracle at two electrons
(restricted, unrestricted, GHF), the fully relaxed orbital gradient
against central differences, and the count of adjoint solves per
evaluation.  On the CPU.

Tolerances: energies 1e-7 (both BFGS runs stop on their own gradient
tests), FCI at two electrons at the JAX suite's 1e-7 / 1e-6, the orbital
gradient 1e-6 against central differences of step 1e-5.

The JAX package's runs of the cases are independent and slow (each
evaluation re-traces its jitted pieces), so one module-scoped fixture
runs them all once, each in its own thread, at most two at a time.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from test_oo import _ham_restricted
from test_torch_casci import port_integral

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ham_polarized():
    from libdmet_preview_tpu.models.integral import Integral
    n = 4
    h = np.zeros((n, n))
    for i in range(n - 1):
        h[i, i + 1] = h[i + 1, i] = -1.0
    stag = np.diag([0.3, -0.3, 0.3, -0.3])
    g = np.zeros((n, n, n, n))
    for i in range(n):
        g[i, i, i, i] = 2.0
    return Integral(n, False, False, 0.0,
                    {"cd": np.array([h + stag, h - stag])},
                    {"ccdd": np.array([g, g, g])})


def _ham_ghf():
    """tests/test_oo.py's spin-orbital expansion of the restricted
    Hamiltonian."""
    from libdmet_preview_tpu.models.integral import Integral
    Ham = _ham_restricted()
    n = Ham.norb
    nso = 2 * n
    h = np.asarray(Ham.H1["cd"][0])
    g = np.asarray(Ham.H2["ccdd"][0])
    H1_so = np.zeros((nso, nso))
    H1_so[:n, :n] = h
    H1_so[n:, n:] = h
    g_so = np.zeros((nso,) * 4)
    a, b = slice(0, n), slice(n, nso)
    for s1 in (a, b):
        for s2 in (a, b):
            g_so[s1, s1, s2, s2] = g
    return Integral(nso, True, False, float(Ham.H0), {"cd": H1_so[None]},
                    {"ccdd": g_so[None]})


CASES = {
    "ooccd-restricted-2e": ("OOCCD", _ham_restricted, 2,
                            dict(restricted=True, oo_gtol=1e-8), 1e-7),
    "ooccd-unrestricted-2e": ("OOCCD", _ham_polarized, 2,
                              dict(restricted=False, Sz=0, oo_gtol=1e-8),
                              1e-6),
    "ooccd-ghf-2e": ("OOCCD", _ham_ghf, 2, dict(ghf=True, oo_gtol=1e-8),
                     1e-6),
    "oomp2-restricted-4e": ("OOMP2", _ham_restricted, 4,
                            dict(restricted=True, oo_gtol=1e-7), None),
}


def _jax_run(case):
    from libdmet_preview_tpu import solvers as jsolvers
    name, make, nelec, kw, _ = CASES[case]
    js = getattr(jsolvers, name)(**kw)
    r1j, Ej = js.run(make(), nelec=nelec)
    return np.asarray(r1j), Ej, js.oo_converged


@pytest.fixture(scope="module")
def jax_runs():
    """{case: (rdm1, E, oo_converged)} of the JAX package."""
    with ThreadPoolExecutor(min(2, len(CASES))) as ex:
        futures = {case: ex.submit(_jax_run, case) for case in CASES}
        return {case: f.result() for case, f in futures.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_oo_matches_jax(case, jax_runs):
    """run() in both packages: E 1e-7, rdm1 1e-6; converged; at two
    electrons OO-CCD == FCI (the JAX suite's tolerance); run_dmet_ham ==
    e_tot (1e-7); one adjoint solve per energy-and-gradient evaluation."""
    from libdmet_preview_tpu_torch import solvers
    from libdmet_preview_tpu_torch.solvers import cc
    name, make, nelec, kw, fci_tol = CASES[case]
    Ham = make()
    r1j, Ej, j_converged = jax_runs[case]
    Ht = port_integral(Ham)
    ts = getattr(solvers, name)(device=CPU, **kw)
    calls = cc._solve_adjoint.calls
    r1t, Et = ts.run(Ht, nelec=nelec)
    assert ts.oo_converged and j_converged
    assert abs(Et - Ej) < 1e-7
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < 1e-6
    # n_eval evaluations in the BFGS run and one for the final RDMs
    assert cc._solve_adjoint.calls - calls == ts.n_eval + 1
    assert abs(ts.run_dmet_ham(Ht) - Et) < 1e-7
    if fci_tol is not None:
        fci = solvers.FCI(restricted=Ham.restricted, ghf=kw.get("ghf", False),
                          tol=1e-12, device=CPU)
        _, Ef = fci.run(Ht, nelec=nelec)
        assert abs(Et - Ef) < fci_tol
    else:
        _, E_mp2 = solvers.MP2(restricted=True, device=CPU).run(Ht,
                                                               nelec=nelec)
        assert Et < E_mp2 + 1e-12


def test_ooccd_beats_ccd_two_electrons():
    from libdmet_preview_tpu_torch.solvers import CCD, OOCCD
    Ht = port_integral(_ham_restricted())
    _, E_ccd = CCD(restricted=True, device=CPU).run(Ht, nelec=2)
    _, E_oo = OOCCD(restricted=True, oo_gtol=1e-8, device=CPU).run(Ht,
                                                                   nelec=2)
    assert E_oo < E_ccd - 1e-8


def test_oomp2_orbital_gradient_central_differences():
    """The fully relaxed OO-MP2 orbital gradient at kappa = 0 (autograd
    through matrix_exp, _mo_so_integrals and _TStar's adjoint) against
    central differences: 1e-6."""
    from libdmet_preview_tpu_torch.solvers import OOMP2
    from libdmet_preview_tpu_torch.solvers.cc import _e_tot_cc
    Ht = port_integral(_ham_restricted())
    nelec, n = 4, Ht.norb
    na = nelec // 2
    oo = OOMP2(restricted=True, device=CPU)
    Ca, _, _, _ = oo._reference(Ht, nelec, None)
    C = torch.as_tensor(Ca)
    blocks = oo._unpack(Ht)
    opts = oo._opts()
    rows = torch.as_tensor(np.repeat(np.arange(na), n - na))
    cols = torch.as_tensor(np.tile(np.arange(na, n), na))

    def e_k(p):
        K = torch.zeros((n, n), dtype=p.dtype).index_put((rows, cols), p)
        Cr = C @ torch.linalg.matrix_exp(K - K.T)
        return _e_tot_cc(*blocks, Cr, Cr, na, na, opts)

    npar = len(rows)
    p0 = torch.zeros(npar, dtype=torch.float64, requires_grad=True)
    (g_ana,) = torch.autograd.grad(e_k(p0), p0)
    eps = 1e-5
    for k in range(npar):
        d = torch.zeros(npar, dtype=torch.float64)
        d[k] = eps
        with torch.no_grad():
            g_num = (float(e_k(d)) - float(e_k(-d))) / (2 * eps)
        assert abs(float(g_ana[k]) - g_num) < 1e-6, (k, float(g_ana[k]),
                                                    g_num)


def test_mp2_as_casci_active_solver():
    """CASCI with the port's MP2 solver in the full window reproduces the
    standalone MP2 energy (1e-8)."""
    from libdmet_preview_tpu_torch.solvers import CASCI, MP2
    Ht = port_integral(_ham_restricted())
    _, E_mp2 = MP2(restricted=True, device=CPU).run(Ht, nelec=4)
    cas = CASCI(Ht.norb, 4, fcisolver=MP2(restricted=True, device=CPU),
                device=CPU)
    _, E_cas = cas.run(Ht, nelec=4)
    assert abs(E_cas - E_mp2) < 1e-8
