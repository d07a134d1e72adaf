"""
The PyTorch port's orbital-optimized CAS solvers (CASSCF, UCASSCF,
GCASSCF of libdmet_preview_tpu_torch/solvers/casci.py) against the JAX
package's on the systems of tests/test_solvers_extra.py, their anchors,
and the gradient and Hessian-vector product of the orbital functional
E(kappa) (autograd through matrix_exp, double backward) against central
differences.  On the CPU.

Tolerances: energies 1e-7 (both orbital optimizers stop on their own
gradient tests), the JAX suite's anchors at its own 1e-6 / 1e-8,
derivatives 1e-7 against central differences of step 1e-4.

The JAX package's three orbital optimizations are independent, so one
module-scoped fixture runs them once, each in its own thread, at most
two at a time.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from test_cc import random_integral
from test_torch_casci import gso_ring, port_integral

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")
E_TOL = 1e-7


def ring_sym_broken():
    """tests/test_solvers_extra.py's UCASSCF system: the 4-site U=4 ring
    with site energies breaking its symmetry."""
    from libdmet_preview_tpu.models.integral import Integral
    nao, U = 4, 4.0
    h = np.zeros((nao, nao))
    for i in range(nao):
        h[i, (i + 1) % nao] = h[(i + 1) % nao, i] = -1.0
    h += np.diag([-0.8, 0.3, -0.1, 0.6])
    g = np.zeros((nao,) * 4)
    for i in range(nao):
        g[i, i, i, i] = U
    return Integral(nao, True, False, 0.0, {"cd": h[None]},
                    {"ccdd": g[None]})


def _jax_casscf(kind):
    from libdmet_preview_tpu.solvers import GCASSCF, UCASSCF
    from libdmet_preview_tpu.solvers.casci import CASSCF
    if kind == "restricted":
        return CASSCF(ncas=2, nelecas=2, max_cycle=25, tol=1e-6).run(
            random_integral(4, restricted=True, seed=11), nelec=4)[1]
    if kind == "unrestricted":
        return UCASSCF(ncas=3, nelecas=2, Sz=0, tol=1e-7, max_cycle=20).run(
            ring_sym_broken(), nelec=4)[1]
    GHam = gso_ring()
    nso, nao = GHam.norb, GHam.norb // 2
    return GCASSCF(ncas=nso - 2, nelecas=nao - 2, tol=1e-7,
                   max_cycle=15).run(GHam, nelec=nao)[1]


@pytest.fixture(scope="module")
def jax_energies():
    """{kind: E} of the JAX package's CASSCF(2, 2) on random_integral(4,
    seed=11), UCASSCF(3, 2) on ring_sym_broken() and GCASSCF on the
    frozen-core window of gso_ring()."""
    kinds = ("restricted", "unrestricted", "ghf")
    with ThreadPoolExecutor(min(2, len(kinds))) as ex:
        futures = {k: ex.submit(_jax_casscf, k) for k in kinds}
        return {k: f.result() for k, f in futures.items()}


def test_casscf_full_space_equals_fci_and_jax(jax_energies):
    """CASSCF(4, 4) == FCI (1e-8, the JAX suite's), and CASSCF(2, 2)
    against the JAX package (1e-7), variational and below CASCI(2, 2)."""
    from libdmet_preview_tpu_torch.solvers import CASCI, CASSCF, FCI
    Ham = random_integral(4, restricted=True, seed=11)
    Ht = port_integral(Ham)
    _, E_fci = FCI(restricted=True, tol=1e-12, device=CPU).run(Ht, nelec=4)
    mc_full = CASSCF(ncas=4, nelecas=4, max_cycle=60, device=CPU)
    _, E_full = mc_full.run(Ht, nelec=4)
    assert abs(E_full - E_fci) < 1e-8

    _, E_casci = CASCI(ncas=2, nelecas=2, device=CPU).run(Ht, nelec=4)
    mc = CASSCF(ncas=2, nelecas=2, max_cycle=25, tol=1e-6, device=CPU)
    rdm1, E_mc = mc.run(Ht, nelec=4)
    E_j = jax_energies["restricted"]
    assert abs(E_mc - E_j) < E_TOL
    assert E_mc <= E_casci + 1e-10
    assert E_mc >= E_fci - 1e-9
    assert abs(float(torch.trace(rdm1[0])) * 2 - 4) < 1e-8
    assert abs(mc.run_dmet_ham(Ht) - E_mc) < 1e-8
    # one Newton minimization per macro iteration but the last
    assert mc.counts["newton"] == mc.n_macro - 1 >= 1
    assert mc.counts["hvp"] > 0


def test_ucasscf_anchors_and_jax(jax_energies):
    """UCASSCF(3, 2) to the JAX suite's anchor -1.8841957321182 (1e-6) and
    the JAX package (1e-7); the full window to FCI -2.1477353252387."""
    from libdmet_preview_tpu_torch.solvers import FCI, UCASCI, UCASSCF
    Ham = ring_sym_broken()
    Ht = port_integral(Ham)
    _, E_fci = FCI(restricted=False, Sz=0, tol=1e-12, device=CPU).run(
        Ht, nelec=4)
    assert abs(E_fci - (-2.1477353252387)) < 1e-8
    _, E_ci = UCASCI(ncas=3, nelecas=2, Sz=0, tol=1e-12, device=CPU).run(
        Ht, nelec=4)
    scf = UCASSCF(ncas=3, nelecas=2, Sz=0, tol=1e-7, max_cycle=20,
                  device=CPU)
    _, E_scf = scf.run(Ht, nelec=4)
    E_j = jax_energies["unrestricted"]
    assert scf.converged
    assert abs(E_scf - (-1.8841957321182)) < 1e-6
    assert abs(E_scf - E_j) < E_TOL
    assert E_scf <= E_ci - 1e-2
    assert abs(scf.run_dmet_ham(Ht) - E_scf) < 1e-8
    assert abs(float(torch.trace(scf.onepdm[0])) - 2.0) < 1e-8
    assert abs(float(torch.trace(scf.onepdm[1])) - 2.0) < 1e-8
    scf_full = UCASSCF(ncas=4, nelecas=4, Sz=0, tol=1e-7, device=CPU)
    _, E_full = scf_full.run(Ht, nelec=4)
    assert abs(E_full - E_fci) < 1e-9


def test_gcasscf_anchors_and_jax(jax_energies):
    """GCASSCF on the ph-transformed ring: the frozen-core window to the
    JAX suite's anchor -8.188240873805 (1e-6) and the JAX package (1e-7),
    the full window to FCI -8.42442890089805 (1e-9)."""
    from libdmet_preview_tpu_torch.solvers import FCI, GCASCI, GCASSCF
    GHam = gso_ring()
    Ht = port_integral(GHam)
    nso, nao = GHam.norb, GHam.norb // 2
    _, E_fci = FCI(restricted=True, ghf=True, tol=1e-12, device=CPU).run(
        Ht, nelec=nao)
    assert abs(E_fci - (-8.42442890089805)) < 1e-8
    _, E_fc = GCASCI(ncas=nso - 2, nelecas=nao - 2, tol=1e-12,
                     device=CPU).run(Ht, nelec=nao)
    scf = GCASSCF(ncas=nso - 2, nelecas=nao - 2, tol=1e-7, max_cycle=15,
                  device=CPU)
    _, E_scf = scf.run(Ht, nelec=nao)
    E_j = jax_energies["ghf"]
    assert scf.converged
    assert abs(E_scf - (-8.188240873805)) < 1e-6
    assert abs(E_scf - E_j) < E_TOL
    assert E_scf <= E_fc - 1e-4
    assert abs(scf.run_dmet_ham(Ht) - E_scf) < 1e-8
    assert abs(float(torch.trace(scf.onepdm[0])) - nao) < 1e-8
    scf_full = GCASSCF(ncas=nso, nelecas=nao, tol=1e-7, device=CPU)
    _, E_full = scf_full.run(Ht, nelec=nao)
    assert abs(E_full - E_fci) < 1e-9


@pytest.mark.parametrize("kind", ["restricted", "unrestricted"])
def test_orbital_gradient_and_hvp_central_differences(kind):
    """The orbital functional of a converged CAS solve at a random
    kappa: autograd gradient and double-backward HVP against central
    differences (step 1e-4; 1e-7)."""
    from libdmet_preview_tpu_torch.solvers import CASSCF, UCASSCF
    if kind == "restricted":
        Ht = port_integral(random_integral(4, restricted=True, seed=11))
        mc = CASSCF(ncas=2, nelecas=2, max_cycle=2, tol=1e-6, device=CPU)
    else:
        Ht = port_integral(ring_sym_broken())
        mc = UCASSCF(ncas=3, nelecas=2, Sz=0, tol=1e-7, max_cycle=2,
                     device=CPU)
    mc.run(Ht, nelec=4)
    opt = mc.orbital
    Cs = [torch.as_tensor(np.asarray(C)) for C in
          (mc.mo_coeff if kind == "unrestricted" else [mc.mo_coeff])]
    npar = sum(opt.sizes)
    rng = np.random.RandomState(5)
    x = 0.05 * rng.randn(npar)
    v = rng.randn(npar)
    v /= np.linalg.norm(v)
    E0, g = opt.grad(x, Cs)
    h = 1e-4
    g_num = np.array([(opt.grad(x + h * e, Cs)[0]
                       - opt.grad(x - h * e, Cs)[0]) / (2 * h)
                      for e in np.eye(npar)])
    assert np.abs(g - g_num).max() < 1e-7
    Hv = opt.hvp(x, v, Cs)
    Hv_num = (opt.grad(x + h * v, Cs)[1] - opt.grad(x - h * v, Cs)[1]) \
        / (2 * h)
    assert np.abs(Hv - Hv_num).max() < 1e-7
