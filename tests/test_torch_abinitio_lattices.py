"""
The ab initio lattices of the PyTorch port (libdmet_preview_tpu_torch/
models/abinitio.py: the factories on engine arrays, the dense-ERI charge
self-consistency, the k-space stripe tier) against the JAX package's
models/abinitio.py on the CPU, and the H-chain DMET loops of
libdmet_preview_tpu_torch/workloads.py (the protocols chip_smoke.py phase
11 drives on the card) against the reference anchors and the JAX loops.

The port's factories read the engine arrays of libdmet_preview_tpu_torch/
data/ (equal to the JAX engine's output, tests/test_torch_engine_ints.py);
the JAX factories build the same arrays with their engine.

Tolerances:
  * E_hf, and what does not depend on the SCF density (the Lowdin
    orbitals, hcore and the ERI in them): 1e-10; the Cholesky factors by
    their reconstructed ERI, 1e-8.
  * what follows the SCF density (the density and Fock stripes; with IAOs
    also the orbitals and every LO operator): 5e-9.  Both packages' SCF
    stops at |dE| < 1e-12 and ||[F, D]|| < 1e-6, where their DIIS paths
    leave AO densities 2e-10 to 1e-9 apart (it moves with the thread
    count); the IAOs of the same occupied MOs agree to 1e-15
    (tests/test_torch_lo.py).  E_hf is variational: 1e-13.
  * the k-space tier on random translation-symmetric integrals of a
    2x2x1 mesh: E 1e-10, stripes 1e-8, the JK tables and stripes 1e-12.
  * the loops: anchors at the JAX suite's tolerances; the IB FCI loop
    within 1e-6 of the JAX loop run here on the same integrals, the UHF
    non-interacting bath 1e-8 of the JAX one.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _d(a, b):
    return float(np.max(np.abs(_n(a) - _n(b))))


def _load(name):
    from libdmet_preview_tpu_torch.models.engine_ints import load_engine_ints
    return load_engine_ints(name)


HCHAIN = "hchain_nk3_nH2_R1.5_vac10_3-21g.npz"
SCF_TOL = 5e-9      # the restricted IAO lattices (see the docstring)


@pytest.fixture(scope="module")
def hchain_pair():
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    return (pa.make_hchain_pbc_lattice(_load(HCHAIN), device=CPU),
            ja.make_hchain_pbc_lattice(nk=3))


def _chol_eri(L):
    L = _n(L)
    n = L.shape[-1]
    return np.einsum("xpq, xrs -> pqrs", L, L).reshape((n,) * 4)


def _compare_factory(port, jax, iao, chol=True):
    """E_hf 1e-10; what follows the SCF density (the density and Fock
    stripes; with IAOs also the orbitals and the operators built on them)
    SCF_TOL; the rest 1e-10."""
    (Lp, mp), (Lj, mj) = port, jax
    assert abs(mp["E_hf"] - mj["E_hf"]) < 1e-10
    orb_tol = SCF_TOL if iao else 1e-10
    for k, tol in (("rdm1_lo_R", SCF_TOL), ("fock_lo_R", SCF_TOL),
                   ("hcore_lo_R", orb_tol)):
        assert _d(getattr(Lp, k), getattr(Lj, k)) < tol, k
    for k, tol in (("rdm1_lo", SCF_TOL), ("fock_lo", SCF_TOL),
                   ("C_ao_lo", orb_tol), ("h_lo", orb_tol)):
        assert _d(mp[k], mj[k]) < tol, k
    assert (Lp.val_idx, Lp.virt_idx, Lp.core_idx) == \
        (Lj.val_idx, Lj.virt_idx, Lj.core_idx)
    assert Lp.H0 == pytest.approx(Lj.H0, abs=1e-12)
    if chol:
        ref = _chol_eri(Lj.Ham.chol_L)
        assert np.abs(_chol_eri(Lp.chol_L) - ref).max() < 1e-8
        assert np.abs(_chol_eri(Lp.chol_L) - _n(mp["eri_lo"])).max() < 1e-8
        assert _d(mp["eri_lo"], mj["eri_lo"]) < orb_tol
        assert _d(Lp.Ham.eri_imp, Lj.Ham.eri_imp) < orb_tol


def test_hchain_factory_matches_jax(hchain_pair):
    _compare_factory(*hchain_pair, iao=True)
    (Lp, mp), (Lj, mj) = hchain_pair
    assert abs(mp["E_hf_elec"] - mj["E_hf_elec"]) < 1e-10
    assert mp["nval"] == mj["nval"] == 2 and mp["nvirt"] == mj["nvirt"] == 2


def test_hchain_uhf_factory_matches_jax():
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    port = pa.make_hchain_pbc_lattice_uhf(_load(HCHAIN), device=CPU)
    jax = ja.make_hchain_pbc_lattice_uhf(nk=3)
    _compare_factory(port, jax, iao=True, chol=False)
    (Lp, mp), (Lj, mj) = port, jax
    for a, b in zip(mp["eri_lo"], mj["eri_lo"]):
        assert _d(a, b) < 1e-10
    assert _d(Lp.Ham.eri_imp, Lj.Ham.eri_imp) < 1e-10
    assert Lp.chol_L is None and Lp.getH2() is None
    # the AFM order of the per-spin densities
    assert np.abs(Lp.rdm1_lo_R[0] - Lp.rdm1_lo_R[1]).max() > 0.3


@pytest.mark.parametrize("basis, localization", [("sto-6g", "lowdin"),
                                                 ("sto-6g", "iao"),
                                                 ("3-21g", "iao"),
                                                 ("3-21g", "lowdin")])
def test_h_ring_factory_matches_jax(basis, localization):
    """The 3-cell, 2-atom H ring of tests/test_abinitio.py (the hring6
    fixture and the 3-21G IAO ring)."""
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    port = pa.make_h_ring_lattice(_load("hring_3x2_r1.8_%s.npz" % basis),
                                  localization=localization, device=CPU)
    jax = ja.make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                 basis=basis, localization=localization,
                                 minimal_ref="sto-6g")
    _compare_factory(port, jax, iao=localization == "iao")
    (Lp, mp), (Lj, mj) = port, jax
    assert (mp["nval"], mp["nvirt"]) == (mj["nval"], mj["nvirt"])
    # the lattice keeps the spin-traced density, as the JAX factory does
    assert abs(np.trace(Lp.rdm1_lo_R[0, 0]) * 3 - 6.0) < 1e-10


def test_molecule_factory_matches_jax():
    """make_molecule_lattice on the H4 chain of tests/test_molecule.py,
    its engine arrays taken from the JAX Mole."""
    from libdmet_preview_tpu.ints.gto import Mole
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    atoms = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.8)),
             ("H", (0.0, 0.0, 3.6)), ("H", (0.0, 0.0, 5.4))]
    mol = Mole(atoms, basis="sto-6g")
    ints = pa.EngineInts(S=mol.intor_ovlp(), hcore=mol.intor_hcore(),
                         eri=mol.intor_eri(), e_nuc=mol.energy_nuc(),
                         nelectron=mol.nelectron, natom=4,
                         nao_atom=mol.nao // 4)
    _compare_factory(pa.make_molecule_lattice(ints, device=CPU),
                     ja.make_molecule_lattice(mol), iao=False)


def test_stripe_helpers_match_jax():
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    from libdmet_preview_tpu_torch.models.lattice import MeshLattice
    rng = np.random.RandomState(3)
    M = rng.randn(5 * 3, 5 * 3)
    assert _d(pa._stripe_symm(M, 5, 3, device=CPU), ja._stripe_symm(M, 5, 3)) < 1e-14
    assert _d(pa._stripe_symm(torch.as_tensor(M), 5, 3),
              ja._stripe_symm(M, 5, 3)) < 1e-14
    tr = MeshLattice((2, 3, 2), 2)._sub_tab
    assert np.array_equal(pa._tr_add_from_diff(tr), ja._tr_add_from_diff(tr))
    M = rng.randn(12 * 2, 12 * 2)
    assert _d(pa._stripe_symm_tr(M, tr, 2, device=CPU),
              ja._stripe_symm_tr(M, tr, 2)) < 1e-14
    st = rng.randn(12, 2, 3)
    assert np.array_equal(_n(pa._expand_stripe_tr(st, tr, device=CPU)),
                          ja._expand_stripe_tr(st, tr))
    S = np.eye(6) + 0.1 * (M[:6, :6] + M[:6, :6].T)
    assert _d(pa.lowdin(S, device=CPU), ja.lowdin(S)) < 1e-14
    assert _d(pa.lowdin(torch.as_tensor(S)), ja.lowdin(S)) < 1e-14
    g = rng.randn(4, 4, 4, 4)
    C = [rng.randn(4, k) for k in (2, 3, 4, 1)]
    ref = np.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, *C)
    assert _d(pa._rot4(torch.as_tensor(g), *map(torch.as_tensor, C)),
              ref) < 1e-12


# ----------------------------------------------------------------------
# dense-ERI charge self-consistency
# ----------------------------------------------------------------------

def _rand_stripe_density(rng, Lat, spin):
    """A density stripe with st[-R] = st[R]^T (a symmetric supercell
    matrix)."""
    nc, n = Lat.ncells, Lat.nscsites
    st = rng.randn(spin, nc, n, n) * 0.1
    st = 0.5 * (st + np.swapaxes(st[:, Lat._neg_map], -1, -2))
    return st


@pytest.mark.parametrize("spin", [1, 2])
def test_update_ham_dense_matches_jax(spin):
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    Lp, mp = pa.make_h_ring_lattice(_load("hring_3x2_r1.8_sto-6g.npz"),
                                    device=CPU)
    Lj, mj = ja.make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                    basis="sto-6g")
    rho = _rand_stripe_density(np.random.RandomState(spin), Lp, spin)
    rho = rho[0] if spin == 1 else rho
    pa.update_ham_dense(Lp, mp, rho)
    ja.update_ham_dense(Lj, mj, rho)
    assert _d(Lp.fock_lo_R, Lj.fock_lo_R) < 1e-10
    assert _d(Lp.fock_lo_k[0], Lj.fock_lo_k[0]) < 1e-10
    assert _d(Lp.fock_lo_k[1], Lj.fock_lo_k[1]) < 1e-10
    assert _d(Lp.rdm1_lo_R, Lj.rdm1_lo_R) == 0.0


def test_update_ham_dense_uhf_matches_jax():
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    Lp, mp = pa.make_hchain_pbc_lattice_uhf(_load(HCHAIN), device=CPU)
    Lj, mj = ja.make_hchain_pbc_lattice_uhf(nk=3)
    rho = _rand_stripe_density(np.random.RandomState(7), Lp, 2)
    pa.update_ham_dense_uhf(Lp, mp, rho)
    ja.update_ham_dense_uhf(Lj, mj, rho)
    assert _d(Lp.fock_lo_R, Lj.fock_lo_R) < 1e-10
    assert _d(Lp.fock_lo_k[0], Lj.fock_lo_k[0]) < 1e-10


# ----------------------------------------------------------------------
# k-space stripe tier
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def kscf_work():
    from libdmet_preview_tpu_torch import workloads as cs
    return cs.make_kscf_workload((2, 2, 1), device=CPU)


def test_jk_tables_and_stripes_match_jax(kscf_work):
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    lat, h_st, S_st, eriF, _, _ = kscf_work
    tr = lat._sub_tab
    Wj, Yj = ja.make_jk_tables(_n(eriF), tr)
    Wp, Yp = pa.make_jk_tables(eriF, tr)
    assert _d(Wp, Wj) < 1e-12 and _d(Yp, Yj) < 1e-12
    rho = np.random.RandomState(2).randn(*h_st.shape)
    Jj, Kj = ja.jk_stripes(rho, Wj, Yj, tr)
    Jp, Kp = pa.jk_stripes(rho, Wp, Yp, tr)
    assert _d(Jp, Jj) < 1e-12 and _d(Kp, Kj) < 1e-12


def test_kscf_stripe_hf_matches_jax(kscf_work):
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    lat, h_st, S_st, eriF, _, nelec = kscf_work
    km = (2, 2, 1)
    Ej, rj, fj = ja.kscf_stripe_hf(h_st, S_st, _n(eriF), lat._sub_tab, km,
                                   nelec, tol=1e-11)
    info = {}
    Ep, rp, fp = pa.kscf_stripe_hf(h_st, S_st, eriF, lat._sub_tab, km,
                                   nelec, tol=1e-11, device=CPU, info=info)
    assert abs(Ep - Ej) < 1e-10
    assert _d(rp, rj) < 1e-8 and _d(fp, fj) < 1e-8
    assert info["n_iter"] > 4
    # from a given starting density as well
    Ej2, rj2, _ = ja.kscf_stripe_hf(h_st, S_st, _n(eriF), lat._sub_tab, km,
                                    nelec, tol=1e-11, dm0_st=rj)
    Ep2, rp2, _ = pa.kscf_stripe_hf(h_st, S_st, eriF, lat._sub_tab, km,
                                    nelec, tol=1e-11, dm0_st=rj, device=CPU)
    assert abs(Ep2 - Ej2) < 1e-10 and _d(rp2, rj2) < 1e-8


def test_kscf_stripe_hf_equals_dense_supercell_hf():
    """The same construction at 2x2x1 as a dense supercell RHF (1e-8), as
    tests/test_pbc_3d.py:78 holds the JAX k-space SCF."""
    from libdmet_preview_tpu_torch import workloads as cs
    err, E_k, E_d = cs.kscf_dense_check(device=CPU)
    assert err < 1e-8


def test_update_ham_eriF_matches_jax(kscf_work):
    """update_ham_eriF on per-k Lowdin LOs: the Fock stripes of both
    packages (1e-10), and at the converged density the update returns the
    converged Fock (the charge self-consistency's fixed point)."""
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu.models.hamiltonian import HamNonInt as JHam
    from libdmet_preview_tpu.models.lattice import MeshLattice as JMesh
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.models import abinitio as pa
    from libdmet_preview_tpu_torch import workloads as cs
    lat, h_st, S_st, eriF, _, nelec = kscf_work
    km = (2, 2, 1)
    tr = lat._sub_tab
    N, m = lat.ncells, h_st.shape[-1]
    S_k = np.fft.fftn(S_st.reshape(km + (m, m)), axes=(0, 1, 2)).reshape(
        N, m, m)
    C_k = np.empty_like(S_k)
    for k in range(N):
        w, v = np.linalg.eigh(S_k[k])
        C_k[k] = (v / np.sqrt(w)) @ v.conj().T
    Cp, _ = pa.lowdin_k(torch.as_tensor(S_st), km)
    assert _d(Cp, C_k) < 1e-12
    Wj, Yj = ja.make_jk_tables(_n(eriF), tr)
    rho = _rand_stripe_density(np.random.RandomState(4), lat, 1)[0]
    Lj = JMesh(km, m)
    Lj.set_Ham_model(JHam(Lj, h_st, np.zeros((m,) * 4)))
    mj = {"kmesh": km, "nlo": m, "C_k": C_k, "W": Wj, "Y": Yj,
          "tr_diff": tr, "h_st": h_st}
    ja.update_ham_eriF(Lj, mj, rho)
    Lp = interop.lattice_from_numpy(km, m, h_st, h_st, device=CPU)
    Wp, Yp = pa.make_jk_tables(eriF, tr)
    mp = {"kmesh": km, "nlo": m, "C_k": Cp, "W": Wp, "Y": Yp,
          "tr_diff": tr, "h_st": h_st}
    pa.update_ham_eriF(Lp, mp, rho)
    assert _d(Lp.fock_lo_R, Lj.fock_lo_R) < 1e-10
    assert _d(mp["fock_lo_R"], mj["fock_lo_R"]) < 1e-10
    # the chip phase's run: the update at the converged density
    out = cs.run_kscf(kscf_work, CPU)
    assert _d(out[3], out[4]) < 1e-10


def test_uhf_incore_matches_jax():
    """_uhf_incore on the 3-21G ring's AO integrals from an AFM density."""
    from libdmet_preview_tpu.models import abinitio as ja
    from libdmet_preview_tpu_torch.models import abinitio as pa
    ints = _load("hring_3x2_r1.8_3-21g.npz")
    n = ints.nao
    dm0 = np.zeros((2, n, n))
    for a in range(ints.natom):
        for ao in range(ints.nao_atom):
            i = a * ints.nao_atom + ao
            dm0[a % 2, i, i] = 1.0 / ints.nao_atom
    Ej, dmj = ja._uhf_incore(ints.S, ints.hcore, ints.eri, dm0, 3, 3,
                             e_nuc=ints.e_nuc, tol=1e-11)
    Ep, dmp = pa._uhf_incore(ints.S, ints.hcore, ints.eri, dm0, 3, 3,
                             e_nuc=ints.e_nuc, tol=1e-11, device=CPU)
    assert abs(Ep - Ej) < 1e-10
    assert _d(dmp, dmj) < 1e-6


# ----------------------------------------------------------------------
# the H-chain loops (workloads.py, chip_smoke.py phase 11, on the CPU)
# ----------------------------------------------------------------------

def jax_ib_fci_loop():
    """tests/test_hchain_pbc.py:106-158 in the JAX package on a fresh
    lattice; returns E/cell."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.models.abinitio import (make_hchain_pbc_lattice,
                                                     update_ham_dense)
    from libdmet_preview_tpu.ops.diis import DIIS
    from libdmet_preview_tpu.ops.fit import make_vcor_trace_unchanged
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import FCI
    Lat, meta = make_hchain_pbc_lattice(nk=3)
    nsc = Lat.nscsites
    filling = 6 / (nsc * 2.0 * 3)
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    solver = FCI(restricted=True, tol=1e-12)
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=4)
    Mu, last_dmu, E_old = 0.0, 0.0, 0.0
    for it in range(12):
        rho, Mu, res = dmet.RHartreeFock(Lat, vcor, filling, Mu, ires=True)
        update_ham_dense(Lat, meta, np.asarray(rho)[0] * 2.0)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args,
            thrnelec=1e-6, delta=0.01, step=0.1)
        last_dmu += dmu
        _, EnergyImp, _ = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        E_cell = EnergyImp * nsc
        vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf,
                                     filling, MaxIter1=500, MaxIter2=0,
                                     ytol=1e-7, gtol=1e-4)
        if it >= 3:
            vcor_new = make_vcor_trace_unchanged(vcor_new, vcor)
        pvcor = (adiis.update(np.hstack(vcor_new.param)) if it >= 4
                 else np.hstack(vcor_new.param))
        dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
        vcor.update(pvcor)
        dE, E_old = E_cell - E_old, E_cell
        if dV < 1e-5 and abs(dE) < 1e-6 and it > 4:
            break
    return float(E_cell)


def jax_nib_uhf():
    """tests/test_hchain_pbc.py:161-198 in the JAX package; returns
    E/cell."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.models.abinitio import (
        make_hchain_pbc_lattice_uhf, update_ham_dense_uhf)
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import FCI
    Lat, meta = make_hchain_pbc_lattice_uhf(nk=3)
    nsc = Lat.nscsites
    filling = 6 / (nsc * 2.0 * 3)
    vcor = VcorLocal(False, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    solver = FCI(restricted=False, tol=1e-12)
    rho, Mu, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
    update_ham_dense_uhf(Lat, meta, np.asarray(rho))
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                              int_bath=False)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    rhoEmb, EnergyEmb, ImpHam, dmu = dmet.MuSolver(adaptive=True)(
        Lat, filling, ImpHam, basis, solver, solver_args, thrnelec=5e-6,
        delta=0.01, step=0.1)
    _, EnergyImp, _ = dmet.transformResults(
        rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=dmu,
        int_bath=False, solver=solver, solver_args=solver_args)
    return float(EnergyImp * nsc)


def test_hchain_ib_fci_loop_anchor_and_jax():
    """Self-consistent IB FCI DMET on the 3-k-point H chain: the anchor
    -1.243085261466 (1e-4) and the JAX loop on the same integrals (1e-6,
    run here: tests/test_hchain_pbc.py's protocol)."""
    from libdmet_preview_tpu_torch import workloads as cs
    Lp, mp = cs.hchain_lattice(_load(HCHAIN), CPU)
    E, recs = cs.run_hchain_dmet(Lp, mp, cs.hchain_solver("FCI", CPU),
                                 cs.IB_PROTOCOL)
    ref, tol = cs.HCHAIN_ANCHORS["IB FCI"]
    assert abs(E - ref) < tol
    assert abs(E - jax_ib_fci_loop()) < 1e-6
    assert abs(E - cs.HCHAIN_JAX["IB FCI"]) < cs.IB_JAX_TOL
    # one iteration replayed from its recorded state
    out = cs.replay_hchain_iteration(Lp, mp, cs.hchain_solver("FCI", CPU),
                                     cs.IB_PROTOCOL, recs[-1])
    assert abs(out[0] - recs[-1]["E"]) < 1e-8
    assert abs(out[3] - recs[-1]["fit_err"]) < 1e-8


def test_hchain_nib_uhf_anchor_and_jax():
    from libdmet_preview_tpu_torch import workloads as cs
    E, afm, hf_err = cs.run_hchain_nib_uhf(_load(HCHAIN), CPU)
    ref, tol = cs.HCHAIN_ANCHORS["NIB UHF"]
    assert abs(E - ref) < tol and afm > 0.3 and hf_err < 1e-7
    assert abs(E - jax_nib_uhf()) < 1e-8


def test_hchain_ccsd_loop_anchor():
    """The CCSD anchor -1.242988933742 (1e-4) through
    tests/test_anchors.py's protocol, and the JAX package's value on the
    same integrals (workloads.HCHAIN_JAX, 1e-5)."""
    from libdmet_preview_tpu_torch import workloads as cs
    name, solver, kw = cs.HCHAIN_VARIANTS[0]
    assert name == "CCSD"
    Lp, mp = cs.hchain_lattice(_load(HCHAIN), CPU)
    E, _ = cs.run_hchain_dmet(Lp, mp, cs.hchain_solver(solver, CPU),
                              cs.ANCHOR_PROTOCOL, **kw)
    ref, tol = cs.HCHAIN_ANCHORS[name]
    assert abs(E - ref) < tol
    assert abs(E - cs.HCHAIN_JAX[name]) < cs.VARIANT_TOL


def test_slice_import_needs_no_jax_or_h5py():
    """The modules of this slice (lo/, the ab initio factories, the
    engine arrays, the integral I/O, the workloads) and chip_smoke load
    neither jax, the JAX package nor h5py."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, libdmet_preview_tpu_torch.lo, "
            "libdmet_preview_tpu_torch.lo.maxloc, "
            "libdmet_preview_tpu_torch.models.abinitio, "
            "libdmet_preview_tpu_torch.models.engine_ints, "
            "libdmet_preview_tpu_torch.models.integral, "
            "libdmet_preview_tpu_torch.workloads, chip_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'h5py', "
            "'libdmet_preview_tpu') or m.startswith(('jax.', 'h5py.', "
            "'libdmet_preview_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
