"""
The PyTorch port's embedding transforms for the 'nearest' / 'full' /
'spin local' lattice-ERI formats and its global-density helpers
(libdmet_preview_tpu_torch/ops/embham.py, dmet/hubbard.get_H_dmet)
against the JAX package on identical NumPy inputs, on the CPU.

transform_eri_*: 1e-11 (the batched 'nearest' transform also against its
plain loop over every cell and, on a 2D mesh, a brute-force supercell
expansion); get_rho_glob_R, get_rdm1_idem, add_bath, get_rdm2_glob_R,
update_lattice_csc, get_E1_from_glob: 1e-9; the (U, V) chain with
interacting bath, whole-lattice impurity == exact diagonalization: 1e-8;
the three-band 'nearest' smoke: 1e-7.
"""

import numpy as np
import pytest
import torch

from test_torch_mfd import jax_ring, port_lattice

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _rand_basis(spin, ncells, nlo, neo, seed=0):
    return np.random.RandomState(seed).randn(spin, ncells, nlo, neo)


@pytest.mark.parametrize("spin", [1, 2])
def test_transform_eri_nearest_matches_jax_and_loop(spin):
    """Dense random blocks on a chain: batched == JAX == the plain loop,
    also when the group size forces several einsum groups."""
    from libdmet_preview_tpu.ops.embham import transform_eri_nearest as tj
    from libdmet_preview_tpu_torch.ops import embham as te
    rng = np.random.RandomState(3)
    ncells, nlo, neo = 4, 2, 3
    eri_R = rng.randn(ncells, nlo, nlo, nlo, nlo) * 0.3
    B = _rand_basis(spin, ncells, nlo, neo, seed=spin)
    ref = tj(B, eri_R)
    out = te.transform_eri_nearest(_t(B), _t(eri_R))
    assert np.abs(out.numpy() - ref).max() < 1e-11
    out1 = te.transform_eri_nearest(_t(B), _t(eri_R), max_bytes=1)
    assert np.abs(out1.numpy() - ref).max() < 1e-11
    loop = te._transform_eri_nearest_loop(_t(B), _t(eri_R))
    assert np.abs(out.numpy() - loop.numpy()).max() < 1e-11


def test_transform_eri_nearest_2d_mesh_sparse_blocks():
    """A 2D mesh with the lattice's cell-addition table and only a few
    non-zero blocks (as an intercell Vpd gives): == JAX, == the loop, and
    == the brute-force expansion to the supercell ERI."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops.embham import transform_eri_nearest as tj
    from libdmet_preview_tpu_torch.ops import embham as te
    Lj, Lt = jdmet.SquareLattice(4, 6, 2, 2), tdmet.SquareLattice(4, 6, 2, 2)
    nc, n, neo = Lt.ncells, 4, 5
    rng = np.random.RandomState(6)
    eri_R = np.zeros((nc, n, n, n, n))
    for R in (0, 1, 4, 5):
        eri_R[R] = rng.randn(n, n, n, n) * 0.3
    B = _rand_basis(2, nc, n, neo, seed=2)
    ref = tj(B, eri_R, lattice=Lj)
    out = te.transform_eri_nearest(_t(B), _t(eri_R), lattice=Lt)
    assert np.abs(out.numpy() - ref).max() < 1e-11
    loop = te._transform_eri_nearest_loop(_t(B), _t(eri_R), lattice=Lt)
    assert np.abs(out.numpy() - loop.numpy()).max() < 1e-11
    big = np.zeros((nc * n,) * 4)
    for C in range(nc):
        for R in range(nc):
            D = Lt.add(C, R)
            big[C * n:(C + 1) * n, C * n:(C + 1) * n,
                D * n:(D + 1) * n, D * n:(D + 1) * n] += eri_R[R]
    Bf = B.reshape(2, nc * n, neo)
    for m, (s1, s2) in enumerate([(0, 0), (1, 1), (0, 1)]):
        bf = np.einsum("pqrs, pi, qj, rk, sl -> ijkl", big, Bf[s1], Bf[s1],
                       Bf[s2], Bf[s2], optimize=True)
        assert np.abs(out[m].numpy() - bf).max() < 1e-10


@pytest.mark.parametrize("spin", [1, 2])
def test_transform_eri_full_matches_jax(spin):
    from libdmet_preview_tpu.ops.embham import transform_eri_full as tj
    from libdmet_preview_tpu_torch.ops.embham import transform_eri_full as tt
    rng = np.random.RandomState(5)
    ncells, nlo, neo = 3, 2, 3
    eri_F = rng.randn(ncells, ncells, ncells, nlo, nlo, nlo, nlo) * 0.2
    B = _rand_basis(spin, ncells, nlo, neo, seed=9)
    assert np.abs(tt(_t(B), _t(eri_F)).numpy() - tj(B, eri_F)).max() < 1e-11


@pytest.mark.parametrize("nchan", [1, 3])
def test_transform_eri_spin_local_matches_jax(nchan):
    from libdmet_preview_tpu.ops.embham import transform_eri_spin_local as tj
    from libdmet_preview_tpu_torch.ops.embham import \
        transform_eri_spin_local as tt
    rng = np.random.RandomState(7)
    eri_S = rng.randn(nchan, 2, 2, 2, 2) * 0.3
    B = _rand_basis(2, 4, 2, 3, seed=11)
    assert np.abs(tt(_t(B), _t(eri_S)).numpy() - tj(B, eri_S)).max() < 1e-11


@pytest.mark.parametrize("fmt", ["nearest", "full", "spin local"])
@pytest.mark.parametrize("int_bath", [True, False])
def test_emb_h2_branches_match_jax(fmt, int_bath):
    """_emb_H2 for each format with both baths on a lattice carried across
    by interop.lattice_from_numpy: 1e-11."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.models.hamiltonian import HamNonInt
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.ops import embham as te
    rng = np.random.RandomState(13)
    Lj = jdmet.ChainLattice(6, 2)
    nc, n = 3, 2
    shape = {"nearest": (nc,), "full": (nc,) * 3, "spin local": (3,)}[fmt]
    H2 = rng.randn(*(shape + (n,) * 4)) * 0.3
    sd = 3 if fmt == "spin local" else None
    H1 = np.asarray(jdmet.Ham(Lj, 4.0).getH1())
    Lj.set_Ham(HamNonInt(Lj, H1, H2, spin_dim_H2=sd))
    Lt = interop.lattice_from_numpy((nc,), n, H1, H1, H2=H2, spin_dim_H2=sd,
                                    device=CPU)
    assert Lt.H2_format == Lj.H2_format == fmt
    B = _rand_basis(2, nc, n, 4, seed=1)
    ref = je._emb_H2(Lj, B, None, int_bath=int_bath)
    out = te._emb_H2(Lt, _t(B), None, int_bath=int_bath)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-11


def test_rho_glob_and_rdm1_idem_match_jax():
    """get_rho_glob_R on a 2D mesh and its idempotent projection: 1e-9
    against the JAX package; the projection is idempotent in k space."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch.ops import embham as te
    rng = np.random.RandomState(5)
    Lj, Lt = jdmet.SquareLattice(4, 6, 2, 2), tdmet.SquareLattice(4, 6, 2, 2)
    Lt.device = CPU
    nc, nlo, neo = Lj.ncells, 4, 7
    basis = rng.randn(2, nc, nlo, neo)
    rho_emb = rng.randn(2, neo, neo)
    rho_emb = rho_emb + rho_emb.transpose(0, 2, 1)
    ref = je.get_rho_glob_R(basis, Lj, rho_emb)
    assert np.abs(te.get_rho_glob_R(_t(basis), Lt, _t(rho_emb)) - ref).max() < 1e-9
    assert np.abs(te.get_rho_glob_R(basis, Lt, rho_emb) - ref).max() < 1e-9

    # a Hermitian global density with a clear occupation gap
    rho_R = rng.randn(2, nc, nlo, nlo) * 0.05
    rho_R = 0.5 * (rho_R + Lt.transpose_stripe(rho_R))
    rho_R[:, 0] += np.diag([0.9, 0.8, 0.2, 0.1])
    kmesh = tuple(int(x) for x in Lt.kmesh)
    nel = nc * nlo * 0.5
    ref = je.get_rdm1_idem(rho_R, [nel, nel], kmesh)
    out = te.get_rdm1_idem(rho_R, [nel, nel], kmesh, device=CPU)
    assert np.abs(out - ref).max() < 1e-9
    full = Lt.expand(out)
    assert np.abs(full @ full - full).max() < 1e-9
    assert abs(np.trace(full[0]) - nel) < 1e-9


def _chain_with_hf(dmet, kw, n=12, filling=0.5, U=4.0):
    Lat = dmet.ChainLattice(n * 2, 2)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, **kw)
    vcor = dmet.VcorLocal(True, False, 2)
    vcor.update(np.zeros(vcor.length()))
    rho, mu = dmet.RHartreeFock(Lat, vcor, filling, 0.0)
    return Lat, vcor, rho


def test_add_bath_matches_jax():
    """add_bath on the half-filled chain from the same basis and band
    structure: the enlarged basis equals the JAX package's (1e-9), its
    first columns are the old ones and all are orthonormal."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch.ops import embham as te
    Lj, _, rho = _chain_with_hf(jdmet, {})
    Lt, _, _ = _chain_with_hf(tdmet, {"device": CPU})
    basis = np.asarray(je.get_emb_basis(Lj, np.asarray(rho)))
    h_re, h_im = Lj.getH1(kspace=True)
    ew, ev = np.linalg.eigh(np.asarray(h_re) + 1j * np.asarray(h_im))
    nocc = ew.size // 2
    ref = je.add_bath(Lj, basis, ew, ev, nocc, nfrac=2)
    out = te.add_bath(Lt, _t(basis), ew, (ev.real, ev.imag), nocc, nfrac=2)
    assert isinstance(out, torch.Tensor) and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() < 1e-9
    neo0, neo1 = basis.shape[-1], out.shape[-1]
    assert neo0 < neo1 <= neo0 + 4
    Bm = out[0].reshape(-1, neo1).numpy()
    assert np.abs(Bm.T @ Bm - np.eye(neo1)).max() < 1e-8
    out3 = te.add_bath(Lt, basis[0], ew, ev, nocc, nfrac=2)
    assert np.abs(out3 - ref[0]).max() < 1e-9


def test_rdm2_glob_matches_jax():
    """get_rdm2_glob_R from a random symmetric rdm2: 1e-9."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch.ops import embham as te
    Lj, Lt = jdmet.SquareLattice(4, 2, 2, 1), tdmet.SquareLattice(4, 2, 2, 1)
    Lt.device = CPU
    rng = np.random.RandomState(0)
    neo = 4
    r2 = rng.randn(neo, neo, neo, neo)
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    r2 = r2 + r2.transpose(2, 3, 0, 1)
    basis = rng.randn(1, Lj.ncells, 2, neo)
    ref = je.get_rdm2_glob_R(basis, Lj, r2)
    out = te.get_rdm2_glob_R(_t(basis), Lt, _t(r2))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-9


def test_csc_update_and_energy_variants_match_jax():
    """On the ab initio H ring (Cholesky H2): update_lattice_csc (veff
    stripe, the new Fock and density, the Fock change), get_E1_from_glob
    and get_H_dmet with E1= and with veff= from the SAME basis and
    embedded rdm1: 1e-9."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch.ops import embham as te
    Lj = jax_ring()
    Lt = port_lattice(Lj)
    keep = (Lj.fock_lo_R, Lj.fock_lo_k, Lj.rdm1_lo_R, Lj.rdm1_lo_k,
            Lj.JK_core)
    try:
        vj = jdmet.VcorLocal(True, False, Lj.nscsites)
        vj.update(np.zeros(vj.length()))
        vt = tdmet.VcorLocal(True, False, Lj.nscsites)
        vt.update(np.zeros(vt.length()))
        rho, mu = jdmet.RHartreeFock(Lj, vj, 0.5, None)
        ImpHam, _, basis = jdmet.ConstructImpHam(Lj, rho, vj, matching=False,
                                                 int_bath=True)
        basis = np.asarray(basis)
        # the port's Hamiltonian in the SAME basis
        ImpHam_t, _ = te.embHam(Lt, _t(basis), vt, int_bath=True)
        neo = basis.shape[-1]
        rng = np.random.RandomState(1)
        x = rng.randn(neo, neo) * 0.05
        rho_emb = (0.5 * np.eye(neo) + x + x.T)[None]

        E1j = je.get_E1_from_glob(Lj, rho_emb, basis)
        E1t = te.get_E1_from_glob(Lt, _t(rho_emb), _t(basis))
        assert abs(E1t - E1j) < 1e-9
        Hj = jdmet.get_H_dmet(basis, Lj, ImpHam, 0.0, E1=E1j,
                              rdm1_emb=rho_emb)
        Ht = tdmet.get_H_dmet(_t(basis), Lt, ImpHam_t, 0.0, E1=E1t,
                              rdm1_emb=_t(rho_emb))
        assert abs(Ht.H0 - Hj.H0) < 1e-9
        assert np.abs(Ht.H1["cd"].numpy() - np.asarray(Hj.H1["cd"])).max() < 1e-9
        assert np.abs(Ht.H2["ccdd"].numpy()
                      - np.asarray(Hj.H2["ccdd"])).max() < 1e-9

        dfj, veffj = je.update_lattice_csc(Lj, rho_emb, basis)
        dft, vefft = te.update_lattice_csc(Lt, _t(rho_emb), _t(basis))
        assert abs(dft - dfj) < 1e-9
        assert np.abs(vefft - veffj).max() < 1e-9
        assert np.abs(Lt.fock_lo_R - np.asarray(Lj.fock_lo_R)).max() < 1e-9
        assert np.abs(Lt.rdm1_lo_R - np.asarray(Lj.rdm1_lo_R)).max() < 1e-9
        for a, b in zip(Lt.fock_lo_k, Lj.fock_lo_k):
            assert np.abs(a - np.asarray(b)).max() < 1e-9

        Hj = jdmet.get_H_dmet(basis, Lj, ImpHam, 0.0, veff=veffj,
                              rdm1_emb=rho_emb)
        Ht = tdmet.get_H_dmet(_t(basis), Lt, ImpHam_t, 0.0, veff=vefft,
                              rdm1_emb=_t(rho_emb))
        assert np.abs(Ht.H1["cd"].numpy() - np.asarray(Hj.H1["cd"])).max() < 1e-9
    finally:
        (Lj.fock_lo_R, Lj.fock_lo_k, Lj.rdm1_lo_R, Lj.rdm1_lo_k,
         Lj.JK_core) = keep


def test_bath_columns_outside_the_reference_cell():
    """An impurity that spans two cells of the stored mesh (imp_idx /
    val_idx beyond nscsites): the bath projector equals the JAX package's
    (1e-8; the columns themselves are gauge dependent)."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu.ops import embham as je
    from libdmet_preview_tpu_torch.ops import embham as te
    Lj, _, rho = _chain_with_hf(jdmet, {}, n=7, filling=3.0 / 7.0)
    Lt, _, _ = _chain_with_hf(tdmet, {"device": CPU}, n=7, filling=3.0 / 7.0)
    idx = [0, 1, 2, 3]
    Bj = np.asarray(je.get_emb_basis(Lj, np.asarray(rho), imp_idx=idx,
                                     val_idx=idx))
    Bt = te.get_emb_basis(Lt, np.asarray(rho), imp_idx=idx,
                          val_idx=idx).numpy()
    assert Bt.shape == Bj.shape
    Pj = Bj[0].reshape(-1, Bj.shape[-1])
    Pt = Bt[0].reshape(-1, Bt.shape[-1])
    assert np.abs(Pt @ Pt.T - Pj @ Pj.T).max() < 1e-8


def _run_ib_dmet(dmet, FCI, ham_mod, build, size, U, kw, fci_kw, max_iter=3):
    """The (U, V) interacting-bath loop of the JAX package's
    tests/test_h2_formats.py.  Returns (E, per-iteration records)."""
    Lat = dmet.ChainLattice(*size)
    Lat.set_Ham(build(ham_mod, Lat), use_hcore_as_emb_ham=True, **kw)
    vcor = dmet.PMInitGuess((Lat.nscsites,), U, 0.5)
    solver = FCI(restricted=True, tol=1e-11, **fci_kw)
    mu_solver = dmet.MuSolver(adaptive=True)
    Mu, last_dmu, E = U * 0.5, 0.0, None
    rec = []
    for it in range(max_iter):
        rho, Mu, res = dmet.RHartreeFock(Lat, vcor, 0.5, Mu, ires=True)
        Lat.update_Ham(np.asarray(rho) * 2.0)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        nel_tot = int(round(Lat.ncells * Lat.nscsites))
        solver_args = {"nelec": min((Lat.ncore + Lat.nval) * 2, nel_tot)}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, 0.5, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        _, E, nelec = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf, 0.5,
                                     MaxIter1=200, MaxIter2=0)
        vcor.update(np.hstack(vcor_new.param))
        rec.append((float(E), float(nelec), last_dmu))
    return float(E), rec


def _both_ib(build, size, U=4.0, max_iter=3):
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu.models.hamiltonian as jham
    from libdmet_preview_tpu.solvers import FCI as FCIj
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    import libdmet_preview_tpu_torch.models.hamiltonian as tham
    from libdmet_preview_tpu_torch.solvers import FCI as FCIt
    out_j = _run_ib_dmet(jdmet, FCIj, jham, build, size, U, {}, {}, max_iter)
    out_t = _run_ib_dmet(tdmet, FCIt, tham, build, size, U, {"device": CPU},
                         {"device": CPU}, max_iter)
    return out_j, out_t


def test_extended_hubbard_ib_dmet_matches_jax():
    """The 6-site (U, V) chain with interacting bath and the 'nearest'
    update_Ham.  With one site per cell (K(R) = K(-R), where the two
    packages' exchange stripes coincide) two iterations equal the JAX
    package's at 1e-8 (E, nelec, dmu); V = 0 in the 'nearest' format
    equals the local format (1e-9); the whole-lattice impurity equals
    exact diagonalization of the ring and the JAX package (1e-8).  With
    the 2-site impurity the port's exchange stripe is the block (R, 0)
    where the JAX package takes (-R, 0): the port lands within 5e-3 of
    exact diagonalization, the JAX package 0.09 above it."""
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.models.hamiltonian import HubbardExtended
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.ops.embham import transform_eri_nearest
    from libdmet_preview_tpu_torch.solvers import FCI
    U, V = 4.0, 1.0
    (Ej, rec_j), (Et, rec_t) = _both_ib(
        lambda m, L: m.HubbardExtended(L, U, V), (6, 1), max_iter=2)
    assert np.abs(np.asarray(rec_t) - np.asarray(rec_j)).max() < 1e-8

    (_, _), (E_near0, _) = _both_ib(
        lambda m, L: m.HubbardExtended(L, U, 0.0), (6, 2), max_iter=2)
    (_, _), (E_local, _) = _both_ib(
        lambda m, L: m.HubbardHamiltonian(L, U), (6, 2), max_iter=2)
    assert abs(E_local - E_near0) < 1e-9

    # exact diagonalization of the 6-site (U, V) ring
    Lat4 = tdmet.ChainLattice(6, 6)
    Ham4 = HubbardExtended(Lat4, U, V)
    Bid = torch.eye(6, dtype=torch.float64).reshape(1, 1, 6, 6)
    eri_full = transform_eri_nearest(Bid, _t(Ham4.getH2()))
    h_full = _t(Lat4.expand(np.asarray(Ham4.getH1())[None]))
    HamI = Integral(6, True, False, 0.0, {"cd": h_full},
                    {"ccdd": eri_full})
    _, E_ed = FCI(restricted=True, tol=1e-11, device=CPU).run(HamI, nelec=6)
    (E_wj, _), (E_wt, _) = _both_ib(
        lambda m, L: m.HubbardExtended(L, U, V), (6, 6), max_iter=1)
    assert abs(E_wt - E_ed / 6.0) < 1e-8
    assert abs(E_wt - E_wj) < 1e-8
    (E_uvj, _), (E_uv, _) = _both_ib(
        lambda m, L: m.HubbardExtended(L, U, V), (6, 2), max_iter=8)
    assert abs(E_uv - E_ed / 6.0) < 5e-3
    assert abs(E_uv - E_ed / 6.0) < abs(E_uvj - E_ed / 6.0)
    assert E_uv > E_local + 0.05


def test_three_band_nearest_smoke_matches_jax():
    """One-shot restricted DMET with the intercell-Vpd 'nearest' H2
    through the interacting-bath transform, as the JAX package's smoke
    test runs it (hole representation, nelec = 2 in the solver).  The
    port gets the JAX lattice's state after its update_Ham through
    interop (the two packages' K stripes differ for this model, see
    test_torch_models_extra.py), then both run ConstructImpHam -> FCI ->
    transformResults: E, nelec per site and the embedding energy at
    1e-7."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.solvers import FCI as FCIj
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import FCI as FCIt
    Lj = jdmet.Square3Band(2, 2, 1, 1)
    Lj.set_Ham(jdmet.Hubbard3band_ref(Lj, name="Hybertsen", hole_rep=True,
                                      ignore_intercell=False),
               use_hcore_as_emb_ham=True)
    filling = 1.0 / 6.0      # one hole per CuO2 in the hole representation
    vj = jdmet.VcorLocal(True, False, 3)
    vj.update(np.zeros(vj.length()))
    rho, mu, res = jdmet.RHartreeFock(Lj, vj, filling, None, ires=True)
    Lj.update_Ham(np.asarray(rho) * 2.0)
    Lt = interop.lattice_from_numpy(
        Lj.kmesh, 3, Lj.hcore_lo_R, Lj.fock_lo_R, H2=Lj.Ham.getH2(),
        rdm1_R=Lj.rdm1_lo_R, use_hcore_as_emb_ham=True, device=CPU)
    vt = tdmet.VcorLocal(True, False, 3)
    vt.update(np.zeros(vt.length()))
    rho_t, _, _ = tdmet.RHartreeFock(Lt, vt, filling, None, ires=True)
    assert np.abs(rho_t - np.asarray(rho)).max() < 1e-10
    nelec = int(round(2 * filling * 3 * 2))
    out = []
    for dmet, Lat, v, r, solver in (
            (jdmet, Lj, vj, rho, FCIj(restricted=True)),
            (tdmet, Lt, vt, rho_t, FCIt(restricted=True, device=CPU))):
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, r, v, matching=False,
                                                  int_bath=True)
        rhoEmb, EEmb = solver.run(ImpHam, nelec=nelec)
        _, E, nel = dmet.transformResults(
            rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
            int_bath=True, solver=solver, solver_args={"nelec": nelec})
        out.append((E, nel, EEmb))
    assert np.abs(np.asarray(out[1]) - np.asarray(out[0])).max() < 1e-7
    assert np.isfinite(out[1][0]) and abs(out[1][1] - 2 * filling) < 0.3


def test_interop_carries_nonlocal_vcor_and_updated_fock():
    """interop: a VcorNonLocal's parameters and rcells, and the lattice's
    Fock / density after update_Ham on a 'nearest' H2, arrive unchanged."""
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.models.hamiltonian import HubbardExtended
    from libdmet_preview_tpu_torch import interop
    Lj = jdmet.ChainLattice(6, 1)
    Lj.set_Ham(HubbardExtended(Lj, 4.0, 1.0), use_hcore_as_emb_ham=False)
    rng = np.random.RandomState(2)
    dm = rng.randn(1, 6, 1, 1) * 0.2
    dm = 0.5 * (dm + Lj.transpose_stripe(dm))
    Lj.update_Ham(dm)
    Lt = interop.lattice_from_numpy(
        Lj.kmesh, 1, Lj.hcore_lo_R, Lj.fock_lo_R, H2=Lj.Ham.getH2(),
        rdm1_R=Lj.rdm1_lo_R, use_hcore_as_emb_ham=False, device=CPU)
    assert Lt.H2_format == "nearest"
    assert np.array_equal(Lt.fock_lo_R, np.asarray(Lj.fock_lo_R))
    assert np.array_equal(Lt.rdm1_lo_R, np.asarray(Lj.rdm1_lo_R))
    Lt.update_Ham(dm)
    assert np.abs(Lt.fock_lo_R - np.asarray(Lj.fock_lo_R)).max() < 1e-11
    vj = jdmet.VcorNonLocal(False, False, Lj, rcells=[0, 1, 5])
    vj.update(rng.randn(vj.length()))
    vt = interop.vcor_nonlocal_from_numpy(False, Lt, vj.param, vj.rcells)
    assert vt.rcells == vj.rcells
    assert np.abs(vt.get(kspace=False) - vj.get(kspace=False)).max() < 1e-12
    with pytest.raises(ValueError):
        interop.vcor_nonlocal_from_numpy(False, Lt, vj.param[:-1], vj.rcells)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_transform_eri_nearest_cuda_batched_vs_loop(cuda_device):
    """On the card, at the three-band 20 x 20 mesh's shape (400 cells of 3
    orbitals, neo = 6, five non-zero blocks): batched == loop at 1e-11 and
    == the CPU result."""
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.ops import embham as te
    Lat = tdmet.Square3Band(20, 20, 1, 1)
    H2 = tdmet.Hubbard3band_ref(Lat, "Hybertsen",
                                ignore_intercell=False).getH2()
    B = _rand_basis(2, 400, 3, 6, seed=4) / 20.0
    dev = cuda_device
    out = te.transform_eri_nearest(_t(B).to(dev), _t(H2).to(dev), lattice=Lat)
    loop = te._transform_eri_nearest_loop(_t(B).to(dev), _t(H2).to(dev),
                                          lattice=Lat)
    cpu = te.transform_eri_nearest(_t(B), _t(H2), lattice=Lat)
    assert float((out - loop).abs().max()) < 1e-11
    assert float((out.cpu() - cpu).abs().max()) < 1e-11
