"""
The ab initio GSO path of the PyTorch port on the CPU: the GSO embedding
ERIs (eri_transform.get_emb_eri_gso_chol, get_emb_eri_gso_gdf) and the
interacting-bath GSO Hamiltonian (GSOHam(int_bath=True),
spinless.get_emb_Ham_ib / get_H_dmet_ib / get_E_dmet_ib) against the JAX
package's and against their oracles, on seeded random factors and on the
3-cell, 2-atom H ring (sto-6g) of the JAX package's host integral engine,
carried across as arrays (interop.abinitio_lattice_from_numpy).

On the CPU get_emb_eri_gso_chol runs the plain version of the symmetric
DF syrk; the card runs the hand-written kernel (chip_smoke.py phase 10c).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ----------------------------------------------------------------------
# the GSO embedding ERIs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ncells, neo", [(1, 4), (3, 5)])
def test_gso_eri_chol_matches_jax_and_brute_force(ncells, neo):
    """get_emb_eri_gso_chol on seeded symmetric factors and a random GSO
    basis: against the JAX package's (1e-12 relative), against the
    explicit species-blocked transform of the dense ERI (1e-10 relative),
    and exactly symmetric under (pq) <-> (rs)."""
    from libdmet_preview_tpu.ops.eri_transform import (
        get_emb_eri_gso_chol as jgso)
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        get_emb_eri_gso_chol)
    rng = np.random.RandomState(14 + ncells)
    nao = 3
    nsite = ncells * nao
    A = rng.randn(7, nsite, nsite)
    L = A + A.transpose(0, 2, 1)
    g = np.einsum("xpq, xrs -> pqrs", L, L)
    basis = rng.randn(1, ncells, 2 * nao, neo)
    got = _np(get_emb_eri_gso_chol(torch.as_tensor(L), basis))
    want = np.asarray(jgso(L, basis))
    scale = np.abs(want).max()
    assert got.shape == (neo,) * 4
    assert np.abs(got - want).max() < 1e-12 * scale
    Ca = basis[0, :, :nao, :].reshape(nsite, neo)
    Cb = basis[0, :, nao:, :].reshape(nsite, neo)
    D = np.einsum("pqrs, pi, qj -> ijrs", g, Ca, Ca) \
        - np.einsum("pqrs, pi, qj -> ijrs", g, Cb, Cb)
    brute = np.einsum("ijrs, rk, sl -> ijkl", D, Ca, Ca) \
        - np.einsum("ijrs, rk, sl -> ijkl", D, Cb, Cb)
    assert np.abs(got - brute).max() < 1e-10 * scale
    M = got.reshape(neo * neo, neo * neo)
    assert np.array_equal(M, M.T)


@lru_cache(maxsize=1)
def h_ring():
    """(JAX lattice, meta) of the 3-cell, 2-atom H ring."""
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    return make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                               basis="sto-6g")


def port_ring():
    """The H ring's arrays in a fresh port ab initio lattice on the CPU."""
    from libdmet_preview_tpu_torch import interop
    Lat, _ = h_ring()
    return interop.abinitio_lattice_from_numpy(
        Lat.kmesh, Lat.nscsites, Lat.hcore_lo_R, Lat.fock_lo_R,
        np.array(Lat.Ham.getH2()), Lat.Ham.eri_imp, Lat.Ham.H0,
        rdm1_R=Lat.rdm1_lo_R, device=CPU)


@pytest.mark.parametrize("tr_symm", [False, True])
def test_gso_eri_gdf_matches_brute_force_and_jax(tr_symm):
    """get_emb_eri_gso_gdf from the H ring's k-resolved factors and a
    random GSO basis: against the dense species-blocked transform of the
    exact LO ERI (1e-10) and against the JAX package's (1e-12)."""
    from libdmet_preview_tpu.ops.eri_transform import (
        get_emb_eri_gso_gdf as jgdf, make_gdf_factors)
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops.eri_transform import (
        get_emb_eri_gso_gdf)
    Lat, meta = h_ring()
    nc, nao = Lat.ncells, Lat.nscsites
    rng = np.random.RandomState(9)
    neo = 4
    basis = rng.randn(1, nc, 2 * nao, neo)
    basis_k = Lat.R2k_basis(basis)
    factors = make_gdf_factors(meta["eri_lo"], nc, nao)
    got = _np(get_emb_eri_gso_gdf(interop.gdf_factors_from_numpy(factors,
                                                                 CPU),
                                  basis_k, nc, nao, tr_symm=tr_symm,
                                  device=CPU))
    g = meta["eri_lo"]
    Ca = basis[0, :, :nao, :].reshape(nc * nao, neo)
    Cb = basis[0, :, nao:, :].reshape(nc * nao, neo)
    D = np.einsum("pqrs, pi, qj -> ijrs", g, Ca, Ca) \
        - np.einsum("pqrs, pi, qj -> ijrs", g, Cb, Cb)
    brute = np.einsum("ijrs, rk, sl -> ijkl", D, Ca, Ca) \
        - np.einsum("ijrs, rk, sl -> ijkl", D, Cb, Cb)
    assert got.shape == (neo,) * 4
    assert np.abs(got - brute).max() < 1e-10
    want = np.asarray(jgdf(factors, basis_k, nc, nao, tr_symm=tr_symm))
    assert np.abs(got - want).max() < 1e-12


# ----------------------------------------------------------------------
# the interacting-bath GSO Hamiltonian on the H ring
# ----------------------------------------------------------------------

def gso_ib_setup(pkg, Lat):
    """GSOHam(int_bath=True) -> GHartreeFock -> ConstructImpHam(GRho_k=
    the mean field's) in the package `pkg` (either hubbard_gso)."""
    _, meta = h_ring()
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    gham = pkg.GSOHam(Lat, int_bath=True)
    GRho, mu, res = pkg.GHartreeFock(gham, filling, mu0=0.0)
    ImpHam, _, basis = pkg.ConstructImpHam(gham, GRho, mu,
                                           GRho_k=res["rho_k"])
    return filling, gham, GRho, mu, res, ImpHam, basis


def test_gso_ib_hamiltonian_matches_jax():
    """GSOHam(int_bath=True) and its embedding Hamiltonian in both
    packages: GH1_full_k, GFock_k, GV0 and the mean-field GRho_R (1e-12),
    the bath projector, the H1 and JK_core spectra, and the GSO ERI
    carried into the JAX basis (1e-10)."""
    from libdmet_preview_tpu.dmet import hubbard_gso as jg
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    Lat_j, _ = make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                   basis="sto-6g")
    _, gj, Gj, muj, _, Hj, Bj = gso_ib_setup(jg, Lat_j)
    _, gt, Gt, mut, _, Ht, Bt = gso_ib_setup(tg, port_ring())
    for a, b in [(gj.GH1_full_k, gt.GH1_full_k), (gj.GFock_k, gt.GFock_k)]:
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
    assert abs(gt.GV0 - gj.GV0) < 1e-12
    assert abs(mut - muj) < 1e-12
    assert np.abs(Gt - np.asarray(Gj)).max() < 1e-12
    B = np.asarray(Bj).reshape(-1, Bj.shape[-1])
    Bp = _np(Bt).reshape(-1, Bt.shape[-1])
    assert np.abs(Bp @ Bp.T - B @ B.T).max() < 1e-10
    for X, Y in [(np.asarray(Hj.H1["cd"][0]), _np(Ht.H1["cd"][0])),
                 (np.asarray(gj.JK_core), _np(gt.JK_core))]:
        assert np.abs(np.linalg.eigvalsh(Y) - np.linalg.eigvalsh(X)).max() \
            < 1e-10
    O = B.T @ Bp
    H2 = _np(Ht.H2["ccdd"][0])
    mapped = np.einsum("ip, jq, kr, ls, pqrs -> ijkl", O, O, O, O, H2)
    assert np.abs(mapped - np.asarray(Hj.H2["ccdd"][0])).max() < 1e-10


def test_gso_ib_hf_identity_and_slater_ib():
    """On the port alone: get_H_dmet_ib evaluated on the mean-field
    embedded GSO determinant equals the lattice HF energy per cell
    (1e-10), and the GSO interacting-bath FCI result equals the
    restricted Slater interacting-bath FCI result (impurity rdm 5e-6,
    nelec 1e-6, E 1e-4; tests/test_gso.py
    test_gso_abinitio_int_bath_equals_slater_ib)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as sdmet
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import embham, spinless
    from libdmet_preview_tpu_torch.solvers import FCI
    from libdmet_preview_tpu_torch.utils import logger as log
    log.verbose = "WARNING"
    _, meta = h_ring()

    Lat = port_ring()
    nlo, ncells = Lat.nscsites, Lat.ncells
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    vcor = sdmet.VcorLocal(True, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    rho, _, _ = sdmet.RHartreeFock(Lat, vcor, filling, None, ires=True)
    ImpHam, H1e, basis = sdmet.ConstructImpHam(Lat, rho, vcor,
                                               matching=False, int_bath=True)
    solver = FCI(restricted=True, tol=1e-12, device=CPU)
    mu_solver = sdmet.MuSolver(adaptive=True)
    args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    last_dmu = 0.0
    for _ in range(30):
        rhoEmb, EEmb, ImpHam, dmu = mu_solver(Lat, filling, ImpHam, basis,
                                              solver, args, step=0.4)
        last_dmu += dmu
        rhoImp_sl, E_sl, n_sl = sdmet.transformResults(
            rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=last_dmu,
            int_bath=True, solver=solver, solver_args=args)
        if abs(n_sl - 2 * filling) < 1e-8:
            break

    Lat2 = port_ring()
    _, gham, _, mu, gres, gImpHam, gbasis = gso_ib_setup(tg, Lat2)
    G_mf = embham.foldRho_k(gres["rho_k"], Lat2.R2k_basis(gbasis))[0]
    H0 = float(Lat2.getH0()) + gham.GH0 + gham.GV0
    Ham_s = spinless.get_H_dmet_ib(Lat2, gbasis, gham.GH1_full_k,
                                   gham.JK_core, gImpHam, H0)
    h1s, gs = Ham_s.H1["cd"][0], Ham_s.H2["ccdd"][0]
    E_mf = float(torch.einsum("pq, qp", h1s, G_mf)
                 + 0.5 * (torch.einsum("pqrs, qp, sr", gs, G_mf, G_mf)
                          - torch.einsum("pqrs, sp, qr", gs, G_mf, G_mf))) \
        + H0
    assert abs(E_mf - meta["E_hf"] / ncells) < 1e-10

    gsolver = FCI(restricted=True, ghf=True, tol=1e-12, device=CPU)
    rdm, E_emb, gImpHam_d, gdmu = tg.SolveImpHam_with_fitting(
        gham, filling, gImpHam, gbasis, gsolver, thrnelec=1e-8)
    GRhoImp, E_gso, n_gso = tg.transformResults(
        rdm, E_emb, gbasis, gImpHam_d, gham, mu, last_dmu=gdmu,
        solver=gsolver)
    rho_A, rho_B, _ = spinless.extract_rdm(GRhoImp)
    rhoImp_phys = _np(rhoImp_sl)[0] * 2.0      # spin-traced
    assert np.max(np.abs(_np(rho_A + rho_B) - rhoImp_phys)) < 5e-6
    assert abs(n_gso - 2 * filling) < 1e-6
    assert abs(E_gso - E_sl) < 1e-4


def test_gso_abinitio_mean_field_and_pairing():
    """GSO mean field on the ab initio ring (NIB flavour, hcore + AFM
    vcor): at zero pairing it is the physical UHF density (1e-8); an
    onsite pairing field develops kappa > 0.05 with the physical filling
    held (1e-6); FCI(ghf=True) on the embedded problem returns a symmetric
    density with the transformed particle count (1e-8)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as sdmet
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import spinless
    from libdmet_preview_tpu_torch.solvers import FCI
    _, meta = h_ring()
    Lat = port_ring()
    Lat.use_hcore_as_emb_ham = True
    nao = Lat.nscsites
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    stag = np.diag([(-1.0) ** i for i in range(nao)])
    va, vb = 0.4 * stag, -0.4 * stag
    vcor = sdmet.VcorLocal(False, False, nao)
    vcor.assign(np.asarray([va, vb]))
    rho, _, _ = sdmet.HartreeFock(Lat, vcor, filling, 0.0, ires=True)

    gham = tg.GSOHam(Lat, use_hcore=True)
    vmat = spinless.combine_vcor([va, vb, np.zeros_like(va)])
    GRho, _, _ = tg.GHartreeFock(gham, filling, mu0=0.0, vcor_mat=vmat)
    rA, rB, kap = spinless.extract_rdm(GRho[0])
    assert np.max(np.abs(kap)) < 1e-10
    assert np.max(np.abs(rA - rho[0, 0])) < 1e-8
    assert np.max(np.abs(rB - rho[1, 0])) < 1e-8

    vmat_sc = spinless.combine_vcor([va, vb, 0.5 * np.eye(nao)])
    GRho_sc, mu_sc, res = tg.GHartreeFock(gham, filling, mu0=0.0,
                                          vcor_mat=vmat_sc)
    assert np.max(np.abs(spinless.extract_rdm(GRho_sc[0])[2])) > 0.05
    assert abs(res["nelec_phys"] - 2 * filling * nao) < 1e-6
    ImpHam, _, basis = tg.ConstructImpHam(gham, GRho_sc, mu_sc,
                                          vcor_mat=vmat_sc)
    neo = basis.shape[-1]
    rdm, _ = FCI(restricted=True, ghf=True, tol=1e-11,
                 device=CPU).run(ImpHam, nelec=neo // 2)
    rdm = _np(rdm)[0]
    assert abs(np.trace(rdm) - neo // 2) < 1e-8
    assert np.max(np.abs(rdm - rdm.T)) < 1e-8
