"""
The PyTorch port's CASCI family (CASCI, UCASCI, GCASCI,
project_active_space, mp2_natural_orbitals of
libdmet_preview_tpu_torch/solvers/casci.py) against the JAX package's on
the systems of tests/test_solvers_extra.py and tests/test_cc.py, and
CASCI inside the port's run_dmet.  On the CPU.

Tolerances: energies 1e-9, RDMs 1e-8 (both packages' FCI stop at 1e-12).
"""

import numpy as np
import pytest
import torch

import jax

from test_cc import hubbard_integral, random_integral, spin_polarized_integral
from test_oo import _ham_restricted

jax.config.update("jax_enable_x64", True)

torch.set_num_threads(1)

CPU = torch.device("cpu")
E_TOL = 1e-9
RDM_TOL = 1e-8


def port_integral(Ham):
    from libdmet_preview_tpu_torch import interop
    return interop.integral_from_numpy(
        Ham.norb, Ham.restricted, Ham.H0, np.asarray(Ham.H1["cd"]),
        np.asarray(Ham.H2["ccdd"]), CPU)


def staggered_chain(n=6, t=1.0, U=4.0, h=0.4):
    """The spin-polarized chain of tests/test_solvers_extra.py's UCASCI
    test."""
    from libdmet_preview_tpu.models.integral import Integral
    h0 = np.zeros((n, n))
    for i in range(n - 1):
        h0[i, i + 1] = h0[i + 1, i] = -t
    stag = np.diag([h * (-1) ** i for i in range(n)])
    g = np.zeros((n, n, n, n))
    for i in range(n):
        g[i, i, i, i] = U
    return Integral(n, False, False, 0.3,
                    {"cd": np.array([h0 + stag, h0 - stag])},
                    {"ccdd": np.array([g, g, g])})


def gso_ring(nao=4, U=3.0):
    """The ph-transformed Hubbard ring of tests/test_solvers_extra.py's
    GCASCI / GCASSCF tests (JAX Integral)."""
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.ops import spinless
    h = np.zeros((nao, nao))
    for i in range(nao):
        h[i, (i + 1) % nao] = h[(i + 1) % nao, i] = -1.0
    g = np.zeros((nao,) * 4)
    for i in range(nao):
        g[i, i, i, i] = U
    mu = U / 2.0
    GH1_c, GH0 = spinless.transform_H1_k(((h[None]),
                                          (np.zeros_like(h)[None])))
    GH1 = spinless.combine_H1_k(GH1_c)
    GV2, GV1, GV0 = spinless.transform_H2_local(g)
    nso = 2 * nao
    H1_so = np.array(GH1[0][0])
    H1_so[:nao, :nao] += GV1[0]
    H1_so[nao:, nao:] += GV1[1]
    H1_so += spinless.mu_matrix(mu, nao)
    eye_basis = np.eye(nso).reshape(1, nso, nso)
    g_so = spinless.transform_eri_local_gso(eye_basis[:, :nao, :],
                                            eye_basis[:, nao:, :], GV2)
    return Integral(nso, True, False, float(GH0 + GV0 - mu * nao),
                    {"cd": H1_so[None]}, {"ccdd": np.asarray(g_so)[None]})


def _rdm2(solver):
    return np.asarray(solver.make_rdm2())


CASCI_CASES = {
    "full-hubbard": (lambda: hubbard_integral(4, 4.0, True), 4, 4, 4),
    "frozen-core-random": (lambda: random_integral(4, True, seed=7), 4, 2, 2),
    "frozen-core-hubbard6": (lambda: hubbard_integral(6, 3.0, True), 6, 4, 4),
}


@pytest.mark.parametrize("case", sorted(CASCI_CASES))
def test_casci_matches_jax(case):
    """CASCI.run / make_rdm2 / run_dmet_ham in both packages: E 1e-9, rdm1
    and rdm2 1e-8, run_dmet_ham == e_tot (1e-9)."""
    from libdmet_preview_tpu.solvers.casci import CASCI as JCASCI
    from libdmet_preview_tpu_torch.solvers import CASCI
    make, nelec, ncas, nelecas = CASCI_CASES[case]
    Ham = make()
    js = JCASCI(ncas=ncas, nelecas=nelecas, tol=1e-12)
    r1j, Ej = js.run(Ham, nelec=nelec)
    ts = CASCI(ncas=ncas, nelecas=nelecas, tol=1e-12, device=CPU)
    Ht = port_integral(Ham)
    r1t, Et = ts.run(Ht, nelec=nelec)
    assert isinstance(r1t, torch.Tensor) and r1t.shape == (1, Ham.norb,
                                                           Ham.norb)
    assert abs(Et - Ej) < E_TOL
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < RDM_TOL
    assert np.abs(_rdm2(ts) - _rdm2(js)).max() < RDM_TOL
    assert abs(ts.run_dmet_ham(Ht) - Et) < E_TOL
    assert abs(ts.run_dmet_ham(Ht) - js.run_dmet_ham(Ham)) < E_TOL


def test_casci_full_space_equals_port_fci():
    from libdmet_preview_tpu_torch.solvers import CASCI, FCI
    Ht = port_integral(random_integral(4, True, seed=7))
    fci = FCI(restricted=True, tol=1e-12, device=CPU)
    r1f, Ef = fci.run(Ht, nelec=4)
    G_f = fci.make_rdm2(Ht)
    cas = CASCI(ncas=4, nelecas=4, tol=1e-12, device=CPU)
    r1c, Ec = cas.run(Ht, nelec=4)
    assert abs(Ec - Ef) < E_TOL
    assert torch.max(torch.abs(r1c - r1f)) < RDM_TOL
    assert torch.max(torch.abs(cas.make_rdm2() - G_f)) < RDM_TOL


def test_mp2_natural_orbitals_match_jax():
    """Occupations 1e-12; the rotation's columns up to sign (1e-10)."""
    from libdmet_preview_tpu.solvers.casci import mp2_natural_orbitals as jno
    from libdmet_preview_tpu_torch.solvers.casci import mp2_natural_orbitals
    rng = np.random.RandomState(3)
    n, nocc = 6, 2
    h = rng.randn(n, n) * 0.1
    h = h + h.T + np.diag(np.arange(n, dtype=float))
    A = rng.randn(10, n, n) * 0.05
    A = A + A.transpose(0, 2, 1)
    g = np.einsum("xpq, xrs -> pqrs", A, A)
    wj, vj = jno(h, g, nocc)
    wt, vt = mp2_natural_orbitals(torch.as_tensor(h), torch.as_tensor(g),
                                  nocc)
    assert np.abs(wt.numpy() - wj).max() < 1e-12
    overlap = np.abs(np.sum(vt.numpy() * vj, axis=0))
    assert np.abs(overlap - 1.0).max() < 1e-10


@pytest.mark.parametrize("ncas,nelecas", [(4, 4), (2, 2)])
def test_project_active_space_matches_jax(ncas, nelecas):
    from libdmet_preview_tpu.solvers.casci import project_active_space as jp
    from libdmet_preview_tpu_torch.solvers import project_active_space, FCI
    Ham = hubbard_integral(4, 3.0, True)
    Hj, infoj = jp(Ham, nelec=4, ncas=ncas, nelecas=nelecas)
    Ht, infot = project_active_space(port_integral(Ham), 4, ncas, nelecas,
                                     device=CPU)
    assert abs(infot["e_core"] - infoj["e_core"]) < E_TOL
    assert torch.max(torch.abs(infot["dm_core"]
                               - torch.as_tensor(infoj["dm_core"]))) < 1e-10
    _, Ej = FCI(restricted=True, tol=1e-12, device=CPU).run(
        port_integral(Hj), nelec=nelecas)
    _, Et = FCI(restricted=True, tol=1e-12, device=CPU).run(Ht,
                                                            nelec=nelecas)
    assert abs(Et - Ej) < E_TOL


@pytest.mark.parametrize("ncas,nelecas", [(6, 6), (4, 4)])
def test_ucasci_matches_jax(ncas, nelecas):
    """UCASCI on the staggered chain: E 1e-9, rdm1 and the three rdm2
    blocks 1e-8, run_dmet_ham == e_tot (1e-9); the full window equals
    the port's unrestricted FCI."""
    from libdmet_preview_tpu.solvers import UCASCI as JUCASCI
    from libdmet_preview_tpu_torch.solvers import UCASCI, FCI
    Ham = staggered_chain()
    js = JUCASCI(ncas, nelecas, tol=1e-12)
    r1j, Ej = js.run(Ham, nelec=6)
    Ht = port_integral(Ham)
    ts = UCASCI(ncas, nelecas, tol=1e-12, device=CPU)
    r1t, Et = ts.run(Ht, nelec=6)
    assert r1t.shape == (2, 6, 6)
    assert abs(Et - Ej) < E_TOL
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < RDM_TOL
    assert np.abs(_rdm2(ts) - _rdm2(js)).max() < RDM_TOL
    assert abs(ts.run_dmet_ham(Ht) - Et) < E_TOL
    if ncas == 6:
        _, Ef = FCI(restricted=False, tol=1e-12, device=CPU).run(Ht, nelec=6)
        assert abs(Et - Ef) < E_TOL


@pytest.mark.parametrize("case", ["full", "frozen-core", "nat-orb"])
def test_gcasci_matches_jax(case):
    """GCASCI on the ph-transformed ring: E 1e-9, rdm1 / rdm2 1e-8,
    run_dmet_ham == e_tot; the natural-orbital window from the FCI rdm1."""
    from libdmet_preview_tpu.solvers import GCASCI as JGCASCI, FCI as JFCI
    from libdmet_preview_tpu_torch.solvers import GCASCI
    GHam = gso_ring()
    nso, nao = GHam.norb, GHam.norb // 2
    kw, run_kw = {}, {}
    ncas, nelecas = nso, nao
    if case == "frozen-core":
        ncas, nelecas = nso - 2, nao - 2
    if case == "nat-orb":
        kw = {"nat_orb": True}
        rdm_fci, _ = JFCI(restricted=True, ghf=True, tol=1e-12).run(
            GHam, nelec=nao)
        run_kw = {"dm0": np.asarray(rdm_fci[0])}
    js = JGCASCI(ncas=ncas, nelecas=nelecas, tol=1e-12, **kw)
    r1j, Ej = js.run(GHam, nelec=nao, **run_kw)
    Ht = port_integral(GHam)
    ts = GCASCI(ncas=ncas, nelecas=nelecas, tol=1e-12, device=CPU, **kw)
    r1t, Et = ts.run(Ht, nelec=nao, **run_kw)
    assert abs(Et - Ej) < E_TOL
    assert np.abs(r1t.numpy() - np.asarray(r1j)).max() < RDM_TOL
    assert np.abs(_rdm2(ts) - _rdm2(js)).max() < RDM_TOL
    assert abs(ts.run_dmet_ham(Ht) - Et) < E_TOL


def test_casci_in_run_dmet_equals_fci_loop():
    """run_dmet(solver=CASCI(neo, nelec)) on the 1D Hubbard chain with the
    interacting bath: the iteration's energy, impurity electron count and
    impurity density equal the FCI loop's (1e-8).  (Later iterations pass
    through the vcor fit's flat valley, where 1e-12 in the fit's input
    moves its stopping point by ~1e-4.)"""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet
    from libdmet_preview_tpu_torch.solvers import CASCI, FCI
    from libdmet_preview_tpu_torch.utils.config import DmetConfig

    def run(solver):
        Lat = dmet.ChainLattice(18, 2)
        Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True,
                    device=CPU)
        vcor = dmet.PMInitGuess([2], 4.0, 0.5)
        cfg = DmetConfig(filling=0.5, restricted=vcor.restricted,
                         int_bath=True, max_iter=1)
        return run_dmet(Lat, vcor, cfg, solver=solver)

    res_f = run(FCI(restricted=True, tol=1e-12, device=CPU))
    res_c = run(CASCI(ncas=4, nelecas=4, tol=1e-12, device=CPU))
    hf, hc = res_f.history[0], res_c.history[0]
    assert abs(hf["E"] - hc["E"]) < 1e-8
    assert abs(hf["nelec"] - hc["nelec"]) < 1e-8
    assert np.abs(hf["rho_imp"] - hc["rho_imp"]).max() < 1e-8


# the oracle systems and the fake Block binary that chip_smoke.py phase 12
# takes from libdmet_preview_tpu_torch/workloads.py
def _oo_ghf():
    from test_torch_oo import _ham_ghf
    return _ham_ghf()


WORKLOAD_SYSTEMS = {
    "hubbard4": (lambda wl: wl.hubbard_integral(4, 4.0),
                 lambda: hubbard_integral(4, 4.0, True)),
    "polarized6": (lambda wl: wl.hubbard_integral(6, 6.0, stag=0.2),
                   lambda: spin_polarized_integral(6, 6.0, 0.2)),
    "random4-seed11": (lambda wl: wl.random_integral(4, 11),
                       lambda: random_integral(4, True, seed=11)),
    "oo": (lambda wl: wl.oo_integral(), lambda: _ham_restricted()),
    "oo-ghf": (lambda wl: wl.spin_orbital_integral(wl.oo_integral()),
               _oo_ghf),
    "gso-ring": (lambda wl: wl.gso_ring(3, 2.0), lambda: gso_ring(3, 2.0)),
}


@pytest.mark.parametrize("case", sorted(WORKLOAD_SYSTEMS))
def test_workload_systems_are_the_jax_suites(case):
    """Each system of workloads.py equals the JAX suite's on the same draws
    (its H0, one-body and two-body blocks, 1e-14)."""
    from libdmet_preview_tpu_torch import workloads as wl
    make_port, make_jax = WORKLOAD_SYSTEMS[case]
    Ht, Hj = make_port(wl), make_jax()
    assert Ht.norb == Hj.norb and Ht.restricted == Hj.restricted
    assert abs(float(Ht.H0) - float(Hj.H0)) < 1e-14
    for key, blk in (("cd", "H1"), ("ccdd", "H2")):
        a = np.asarray(getattr(Ht, blk)[key])
        b = np.asarray(getattr(Hj, blk)[key])
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-14


def test_fake_block_is_the_jax_suites():
    from test_dmrg_bridge import FAKE
    from libdmet_preview_tpu_torch import workloads as wl
    assert wl.FAKE_BLOCK == FAKE
