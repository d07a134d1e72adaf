"""
Tailored CC in the PyTorch port (TCCSD / UTCCSD / GTCCSD, _TStarFrozen,
the frozen amplitude solve and the masked adjoint of
libdmet_preview_tpu_torch/solvers/cc.py) and the CI -> CC amplitude
extraction (solvers/ci_to_cc.py) against the JAX package's on the systems
of tests/test_cc.py:173-280.  On the CPU.

Tolerances: amplitudes 1e-12 (same CI vector), energies 1e-9, rdm1 1e-8,
run_dmet_ham == e_tot 1e-8, the _TStarFrozen backward against central
differences 1e-7.

The JAX package's TCCSD runs of the cases are independent, so one
module-scoped fixture runs them all once, each in its own thread, at
most two at a time.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from test_cc import hubbard_integral, spin_polarized_integral
from test_torch_casci import port_integral

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _jax_ci(Ham, norb, nelec):
    """A JAX FCI vector of the Hamiltonian (host array)."""
    from libdmet_preview_tpu.solvers.fci import fci_kernel
    h1 = np.asarray(Ham.H1["cd"])
    g = np.asarray(Ham.H2["ccdd"])
    if Ham.restricted:
        _, ci = fci_kernel(h1[0], g[0], norb, nelec, tol=1e-12)
    else:
        _, ci = fci_kernel((h1[0], h1[1]), (g[0], g[2], g[1]), norb, nelec,
                           tol=1e-12)
    return np.asarray(ci)


@pytest.mark.parametrize("case", ["restricted-4-(2,2)", "polarized-4-(2,2)",
                                  "polarized-6-(3,2)"])
def test_ci_to_cc_matches_jax(case):
    """ci_amplitudes and ci_to_cc_so on the same CI vector, given as an
    array and as a tensor: 1e-12."""
    from libdmet_preview_tpu.solvers import ci_to_cc as jc
    from libdmet_preview_tpu_torch.solvers import ci_to_cc as tc
    if case.startswith("restricted"):
        Ham, norb, nelec = hubbard_integral(4, 4.0, True), 4, (2, 2)
    elif case == "polarized-4-(2,2)":
        Ham, norb, nelec = spin_polarized_integral(4, 4.0, 0.3), 4, (2, 2)
    else:
        Ham, norb, nelec = spin_polarized_integral(6, 3.0, 0.2), 6, (3, 2)
    ci = _jax_ci(Ham, norb, nelec)
    for a, b in zip(jc.ci_amplitudes(ci, norb, nelec),
                    tc.ci_amplitudes(torch.as_tensor(ci), norb, nelec)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12
    t1j, t2j = jc.ci_to_cc_so(ci, norb, nelec)
    t1t, t2t = tc.ci_to_cc_so(ci, norb, nelec)
    assert np.abs(t1t - t1j).max() <= 1e-12
    assert np.abs(t2t - t2j).max() <= 1e-12


TCC_CASES = {
    "full-cas-restricted": (lambda: hubbard_integral(4, 4.0, True), 4,
                            dict(ncas=4, nelecas=4, restricted=True,
                                 tol=1e-10)),
    "full-cas-polarized": (lambda: spin_polarized_integral(4, 4.0, 0.3), 4,
                           dict(ncas=4, nelecas=4, restricted=False,
                                tol=1e-10)),
    "(4,4)-hubbard6": (lambda: hubbard_integral(6, 4.0, True), 6,
                       dict(ncas=4, nelecas=4, restricted=True, tol=1e-9)),
    "(2,2)-polarized6": (lambda: spin_polarized_integral(6, 6.0, 0.2), 6,
                         dict(ncas=2, nelecas=2, restricted=False,
                              tol=1e-9)),
    "(4,(2,1))-polarized5": (lambda: spin_polarized_integral(5, 4.0, 0.3),
                             5, dict(ncas=4, nelecas=(2, 1), Sz=1,
                                     restricted=False, tol=1e-10)),
}


def _jax_tccsd(case):
    from libdmet_preview_tpu.solvers.cc import TCCSD as JTCCSD
    make, nelec, kw = TCC_CASES[case]
    r1j, Ej = JTCCSD(**kw).run(make(), nelec=nelec)
    return np.asarray(r1j), Ej


@pytest.fixture(scope="module")
def jax_tccsd():
    """{case: (rdm1, E)} of the JAX package's TCCSD."""
    with ThreadPoolExecutor(min(2, len(TCC_CASES))) as ex:
        futures = {case: ex.submit(_jax_tccsd, case) for case in TCC_CASES}
        return {case: f.result() for case, f in futures.items()}


@pytest.mark.parametrize("case", sorted(TCC_CASES))
def test_tccsd_matches_jax(case, jax_tccsd):
    """TCCSD.run in both packages: E 1e-9, rdm1 1e-8; run_dmet_ham ==
    e_tot (1e-8); the full CAS equals the port's FCI (1e-7)."""
    from libdmet_preview_tpu_torch.solvers import FCI, TCCSD
    make, nelec, kw = TCC_CASES[case]
    Ham = make()
    r1j, Ej = jax_tccsd[case]
    Ht = port_integral(Ham)
    ts = TCCSD(device=CPU, **kw)
    r1t, Et = ts.run(Ht, nelec=nelec)
    assert tuple(r1t.shape) == np.shape(r1j)
    assert abs(Et - Ej) < 1e-9
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < 1e-8
    assert abs(ts.run_dmet_ham(Ht) - Et) < 1e-8
    if case.startswith("full"):
        _, Ef = FCI(restricted=Ham.restricted, tol=1e-12, device=CPU).run(
            Ht, nelec=nelec)
        assert abs(Et - Ef) < 1e-7


def test_tccsd_beats_ccsd_strong_coupling():
    """TCCSD(4,4) on the 6-site U=4 chain is closer to FCI than RCCSD
    (tests/test_cc.py's oracle) in the port."""
    from libdmet_preview_tpu_torch.solvers import CCSD, FCI, TCCSD
    Ht = port_integral(hubbard_integral(6, 4.0, True))
    _, E_fci = FCI(restricted=True, tol=1e-12, device=CPU).run(Ht, nelec=6)
    _, E_cc = CCSD(restricted=True, tol=1e-9, device=CPU).run(Ht, nelec=6)
    _, E_tcc = TCCSD(ncas=4, nelecas=4, restricted=True, tol=1e-9,
                     device=CPU).run(Ht, nelec=6)
    assert abs(E_tcc - E_fci) < abs(E_cc - E_fci)


def _frozen_problem():
    """Spin-orbital integrals, masks and frozen amplitudes of TCCSD(2,2)
    on the 6-site polarized chain (port tensors)."""
    from libdmet_preview_tpu_torch.solvers import TCCSD, cc
    from libdmet_preview_tpu_torch.utils.misc import as_f64
    Ht = port_integral(spin_polarized_integral(6, 6.0, 0.2))
    tcc = TCCSD(ncas=2, nelecas=2, restricted=False, tol=1e-11, device=CPU)
    captured = {}
    orig = cc._e_tot_tcc

    def capture(*args):
        captured["args"] = args
        return orig(*args)

    TCCSD.energy_fn = staticmethod(capture)
    try:
        tcc.run(Ht, nelec=6)
    finally:
        TCCSD.energy_fn = staticmethod(orig)
    a = captured["args"]
    blocks = [x.detach() for x in a[:5]]
    Ca, Cb, na, nb, opts = a[5:10]
    m1, t1f, m2, t2f = a[10:]
    with torch.no_grad():
        h_so, g = cc._mo_so_integrals(blocks[:2], blocks[2:], as_f64(Ca, CPU),
                                      as_f64(Cb, CPU), na, nb)
        W = cc._antisymmetrize(g)
    return h_so, W, m1, t1f, m2, t2f, na + nb, opts


def test_tstar_frozen_backward_central_differences():
    """d/deps of the tailored correlation energy at (h + eps dh, W + eps dW)
    against the _TStarFrozen backward: 1e-7 with a step of 1e-4; the
    frozen entries come back unchanged and receive no cotangent."""
    from libdmet_preview_tpu_torch.solvers import cc
    h_so, W, m1, t1f, m2, t2f, nocc, opts = _frozen_problem()
    opts = tuple((k, 1e-12 if k == "tol" else v) for k, v in opts)
    rng = np.random.RandomState(4)
    dh = torch.as_tensor(rng.randn(*h_so.shape) * 0.01)
    dh = dh + dh.T
    # a chemist perturbation with the 8-fold symmetry of real ERIs
    dg = torch.as_tensor(rng.randn(*W.shape) * 0.01)
    dg = dg + dg.permute(1, 0, 2, 3)
    dg = dg + dg.permute(0, 1, 3, 2)
    dW = cc._antisymmetrize(dg + dg.permute(2, 3, 0, 1))

    def ecorr(h, Wx):
        t1, t2 = cc._TStarFrozen.apply(h, Wx, m1, t1f, m2, t2f, nocc, opts)
        return cc._ecorr(t1, t2, h, Wx, nocc), t1, t2

    h_ = h_so.clone().requires_grad_(True)
    W_ = W.clone().requires_grad_(True)
    E, t1, t2 = ecorr(h_, W_)
    assert torch.equal(t1[m1 > 0], t1f[m1 > 0])
    assert torch.equal(t2[m2 > 0], t2f[m2 > 0])
    calls = cc._solve_adjoint_masked.calls
    gh, gW = torch.autograd.grad(E, (h_, W_))
    assert cc._solve_adjoint_masked.calls == calls + 1
    assert cc._solve_adjoint_masked.last["residual"] < 1e-9
    ana = float(torch.sum(gh * dh) + torch.sum(gW * dW))
    eps = 1e-4
    with torch.no_grad():
        Ep = ecorr(h_so + eps * dh, W + eps * dW)[0]
        Em = ecorr(h_so - eps * dh, W - eps * dW)[0]
    num = float(Ep - Em) / (2 * eps)
    assert abs(ana - num) < 1e-7 * max(1.0, abs(num))


def test_solve_amplitudes_frozen_matches_jax():
    """The frozen amplitude solve and the masked adjoint on the same
    inputs in both packages: 1e-10."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.solvers import cc as jcc
    from libdmet_preview_tpu_torch.solvers import cc
    h_so, W, m1, t1f, m2, t2f, nocc, _ = _frozen_problem()
    j = [jnp.asarray(x.numpy()) for x in (h_so, W, m1, t1f, m2, t2f)]
    t1j, t2j, cj = jcc._solve_amplitudes_frozen(j[0], j[1], j[2], j[3], j[4],
                                                j[5], nocc, tol=1e-12)
    t1t, t2t, ct = cc._solve_amplitudes_frozen(h_so, W, m1, t1f, m2, t2f,
                                               nocc, tol=1e-12)
    assert cj and ct
    assert np.abs(t1t.numpy() - np.asarray(t1j)).max() < 1e-10
    assert np.abs(t2t.numpy() - np.asarray(t2j)).max() < 1e-10
    # cotangents as the energy gives them: zero on the frozen entries, w2
    # antisymmetric in (i, j) and in (a, b)
    rng = np.random.RandomState(9)
    w1 = rng.randn(*t1t.shape) * (1 - m1.numpy())
    w2 = cc._P2(torch.as_tensor(rng.randn(*t2t.shape))).numpy() \
        * (1 - m2.numpy())
    l1j, l2j = jcc._solve_adjoint_masked(j[0], j[1], nocc, t1j, t2j,
                                         jnp.asarray(w1), jnp.asarray(w2),
                                         j[2], j[4], tol=1e-12)
    l1t, l2t = cc._solve_adjoint_masked(h_so, W, nocc, t1t, t2t,
                                        torch.as_tensor(w1),
                                        torch.as_tensor(w2), m1, m2,
                                        tol=1e-12)
    assert cc._solve_adjoint_masked.last["branch"] == "diis-richardson"
    scale = max(np.abs(np.asarray(l2j)).max(), 1.0)
    assert np.abs(l1t.numpy() - np.asarray(l1j)).max() < 1e-10 * scale
    assert np.abs(l2t.numpy() - np.asarray(l2j)).max() < 1e-10 * scale
