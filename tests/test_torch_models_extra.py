"""
The PyTorch port's model-lattice family (libdmet_preview_tpu_torch/
models/lattice.py factories and stripe helpers, models/hamiltonian.py
factories, ops/vcor.py classes, ops/pbc_helper.py, ops/mfd.py HF with a
non-local vcor / HF_scf / GHF) against the JAX package on identical NumPy
inputs, on the CPU.  Geometry, Hamiltonians and vcor tables: 1e-12; J/K:
1e-11; mean fields: 1e-8; the three-band one-shot DMET: 1e-7.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _pkgs():
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    return jdmet, tdmet


FACTORIES = {
    "Square3Band": (2, 4, 1, 1),
    "Square3BandAFM": (4, 2, 1, 1),
    "Square3BandSymm": (2, 2),
    "CubicLattice": (2, 2, 4, 1, 1, 2),
    "HoneycombLattice": (3, 3, 1, 1),
    "SquareLattice": (4, 6, 2, 2),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_lattice_factory_matches_jax(name):
    """Sites, cells, names, neighbour distances, the cell-index tables and
    the neighbour search: exactly equal."""
    jdmet, tdmet = _pkgs()
    Lj = getattr(jdmet, name)(*FACTORIES[name])
    Lt = getattr(tdmet, name)(*FACTORIES[name])
    assert Lt.nscsites == Lj.nscsites and Lt.ncells == Lj.ncells
    assert np.abs(Lt.sites - Lj.sites).max() < 1e-12
    assert np.array_equal(Lt.cells, Lj.cells)
    assert Lt.supercell.names == Lj.supercell.names
    assert np.allclose(Lt.neighborDist, Lj.neighborDist, atol=1e-12)
    for tab in ("_add_tab", "_sub_tab", "_neg_map"):
        assert np.array_equal(getattr(Lt, tab), getattr(Lj, tab))
    d = Lj.neighborDist[0]
    assert Lt.neighbor(dis=d, sitesA=range(Lt.nscsites)) == \
        Lj.neighbor(dis=d, sitesA=range(Lj.nscsites))


def test_square3band_afm_nonsymmetric_cell_and_bipartite():
    jdmet, tdmet = _pkgs()
    Lj = jdmet.Square3BandAFM(2, 2, 1, 1, symm=False)
    Lt = tdmet.Square3BandAFM(2, 2, 1, 1, symm=False)
    assert np.abs(Lt.sites - Lj.sites).max() < 1e-12
    assert tdmet.BipartiteSquare((2, 4)) == jdmet.BipartiteSquare((2, 4))


def test_expand_extract_transpose_stripe():
    """expand / extract_stripe / transpose_stripe on a 2D mesh: equal to
    the JAX package's (1e-12); expand then extract is the identity, and
    the transposed stripe expands to the transposed matrix."""
    jdmet, tdmet = _pkgs()
    Lj, Lt = jdmet.SquareLattice(4, 6, 2, 2), tdmet.SquareLattice(4, 6, 2, 2)
    A = np.random.RandomState(0).randn(2, Lj.ncells, 4, 4)
    big = Lt.expand(A)
    assert np.abs(big - Lj.expand(A)).max() < 1e-12
    assert np.abs(Lt.extract_stripe(big) - A).max() < 1e-12
    assert np.abs(Lt.extract_stripe(big) - Lj.extract_stripe(big)).max() < 1e-12
    At = Lt.transpose_stripe(A)
    assert np.abs(At - Lj.transpose_stripe(A)).max() < 1e-12
    assert np.abs(Lt.expand(At) - big.transpose(0, 2, 1)).max() < 1e-12


def _ham_cases():
    return {
        "extended_chain": ("ChainLattice", (8, 2),
                           lambda m, L: m.HubbardExtended(L, 4.0, 1.5)),
        "extended_square": ("SquareLattice", (4, 6, 2, 2),
                            lambda m, L: m.HubbardExtended(
                                L, 4.0, 1.0, tlist=(1.0, 0.3))),
        "3band_local": ("Square3Band", (2, 2, 1, 1),
                        lambda m, L: m.Hubbard3band(
                            L, 10.5, 4.0, -8.1, -1.3, -0.65, tpp1=0.1,
                            Vpd=1.2)),
        # one cell along x: the JAX package mirrors an intercell Vpd entry
        # to (-R) % ncells, the cell -R on a 1D mesh only
        "3band_nearest": ("Square3Band", (1, 4, 1, 1),
                          lambda m, L: m.Hubbard3band(
                              L, 10.5, 4.0, -8.1, -1.3, -0.65, Vpd=1.2,
                              ignore_intercell=False)),
        "3band_ref_hanke_afm": ("Square3BandAFM", (4, 4, 1, 1),
                                lambda m, L: m.Hubbard3band_ref(L, "Hanke")),
        "3band_ref_hole": ("Square3BandSymm", (1, 3),
                           lambda m, L: m.Hubbard3band_ref(
                               L, "Hybertsen", hole_rep=True,
                               ignore_intercell=False)),
        "3band_ref_dict_min": ("Square3Band", (2, 2, 1, 1),
                               lambda m, L: m.Hubbard3band_ref(
                                   L, {"Ud": 8.0, "tpd": 1.1, "D_pd": 3.0,
                                       "Up": 2.0}, min_model=True,
                                   factor=0.5)),
        "dca": ("ChainLattice", (8, 2),
                lambda m, L: m.HubbardDCA(L, m.ChainLattice(32, 2), 4.0)),
        "dca_square": ("SquareLattice", (4, 4, 2, 2),
                       lambda m, L: m.HubbardDCA(
                           L, m.SquareLattice(8, 8, 2, 2), 2.0)),
    }


@pytest.mark.parametrize("case", sorted(_ham_cases()))
def test_hamiltonian_factory_matches_jax(case):
    """H1 stripe, H2 and its detected format: 1e-12."""
    import libdmet_preview_tpu.models.hamiltonian as jham
    import libdmet_preview_tpu.models.lattice as jlat
    import libdmet_preview_tpu_torch.models.hamiltonian as tham
    import libdmet_preview_tpu_torch.models.lattice as tlat

    class Both(object):
        def __init__(self, ham, lat):
            self.ham, self.lat = ham, lat

        def __getattr__(self, name):
            return getattr(self.ham, name, None) or getattr(self.lat, name)

    factory, args, build = _ham_cases()[case]
    out = []
    for ham, lat in ((jham, jlat), (tham, tlat)):
        m = Both(ham, lat)
        out.append(build(m, getattr(lat, factory)(*args)))
    Hj, Ht = out
    assert Ht.H2_format == Hj.H2_format
    assert np.abs(np.asarray(Ht.getH1()) - np.asarray(Hj.getH1())).max() < 1e-12
    assert np.asarray(Ht.getH2()).shape == np.asarray(Hj.getH2()).shape
    assert np.abs(np.asarray(Ht.getH2()) - np.asarray(Hj.getH2())).max() < 1e-12


def _vcor_cases():
    c4 = [[1, 3, 0, 2], [2, 0, 3, 1]]          # 2x2 plaquette rotations
    return {
        "nonlocal_u": lambda m, L: m.VcorNonLocal(False, False, L,
                                                  rcells=[0, 1, 3]),
        "nonlocal_r": lambda m, L: m.VcorNonLocal(True, False, L),
        "kpoints": lambda m, L: m.VcorKpoints(False, False, L),
        "restricted_r": lambda m, L: m.VcorRestricted(True, False, [0, 2],
                                                      [1, 3]),
        "restricted_u": lambda m, L: m.VcorRestricted(False, False, [1, 2],
                                                      [0, 3]),
        "restricted_det": lambda m, L: m.VcorRestricted(False, False, [],
                                                        range(4)),
        "symm_r": lambda m, L: m.VcorSymm(True, False, 4, c4),
        "symm_spin": lambda m, L: m.VcorSymm(False, False, 4, c4,
                                             spin_swap=[True, False]),
        "phsymm": lambda m, L: m.VcorLocalPhSymm(
            4.0, False, (2, 2), *m.BipartiteSquare((2, 2))),
        "phsymm_r": lambda m, L: m.VcorLocalPhSymm(
            4.0, False, (2, 2), *m.BipartiteSquare((2, 2)), r=1.0),
        "dca_phsymm": lambda m, L: m.VcorDCAPhSymm(
            6.0, (2, 2), *m.BipartiteSquare((2, 2))),
        "dca_phsymm_1d": lambda m, L: m.VcorDCAPhSymm(
            2.0, (4,), [0, 2], [1, 3]),
    }


@pytest.mark.parametrize("case", sorted(_vcor_cases()))
def test_vcor_class_matches_jax(case):
    """Parameter count, get() (R and k space for the non-local classes),
    gradient() and assign(): 1e-12 on a seeded parameter vector."""
    jdmet, tdmet = _pkgs()
    build = _vcor_cases()[case]
    # the non-local classes sit on a chain (4 cells of 4 sites): the JAX
    # package negates the flattened cell index, which is the cell -R on a
    # 1D mesh only
    vj = build(jdmet, jdmet.ChainLattice(16, 4))
    vt = build(tdmet, tdmet.ChainLattice(16, 4))
    assert vt.length() == vj.length()
    assert vt.restricted == vj.restricted and vt.islocal() == vj.islocal()
    p = np.random.RandomState(3).randn(vj.length())
    vj.update(p)
    vt.update(p)
    if vj.islocal():
        assert np.abs(vt.get() - vj.get()).max() < 1e-12
        assert np.abs(vt.gradient() - vj.gradient()).max() < 1e-12
        target = np.random.RandomState(4).randn(*vj.get().shape)
        target = target + target.transpose(0, 2, 1)
        dj, dt = vj.diag_indices(), vt.diag_indices()
        assert (dj is None) == (dt is None)
        if dj is not None:
            assert all(np.array_equal(a, b) for a, b in zip(dj, dt))
    else:
        assert np.abs(vt.get(kspace=False) - vj.get(kspace=False)).max() < 1e-12
        for a, b in zip(vt.get(), vj.get()):
            assert np.abs(a - np.asarray(b)).max() < 1e-12
        assert np.abs(vt.gradient_R() - vj.gradient_R()).max() < 1e-12
        target = np.random.RandomState(4).randn(*vj.get(kspace=False).shape)
    vj.assign(target)
    vt.assign(target)
    assert np.abs(vt.param - vj.param).max() < 1e-12


def test_2d_mesh_negation_uses_the_cell_algebra():
    """On a 2D mesh the port takes -R from the lattice's cell-index
    algebra where the JAX package negates the flattened index: the
    intercell-Vpd ERI has (pq|rs) = (rs|pq) over the supercell, a
    VcorNonLocal's V(k) is Hermitian.  update_Ham's 'nearest' Fock
    equals hcore + J - K/2 from the fully expanded supercell ERI (the
    JAX package's K stripe is the block (-R, 0) in place of (R, 0), which
    differs for the three-band model)."""
    from libdmet_preview_tpu_torch.ops import pbc_helper
    _, tdmet = _pkgs()
    Lat = tdmet.Square3Band(3, 4, 1, 1)
    Ham = tdmet.Hubbard3band_ref(Lat, "Hybertsen", ignore_intercell=False)
    eri_R = Ham.getH2()
    nc, n = Lat.ncells, 3
    for R in range(nc):
        assert np.abs(eri_R[Lat._neg_map[R]]
                      - eri_R[R].transpose(2, 3, 0, 1)).max() < 1e-12
    v = tdmet.VcorNonLocal(False, False, Lat, rcells=[0, 1, 4, 5])
    v.update(np.random.RandomState(0).randn(v.length()))
    v_re, v_im = v.get()
    Vk = v_re + 1j * v_im
    assert np.abs(Vk - Vk.conj().transpose(0, 1, 3, 2)).max() < 1e-12
    Lat.set_Ham(Ham, use_hcore_as_emb_ham=False, device=CPU)
    rng = np.random.RandomState(1)
    dm = rng.randn(1, nc, n, n) * 0.2
    dm = 0.5 * (dm + Lat.transpose_stripe(dm))
    Lat.update_Ham(dm)
    vj, vk = pbc_helper.get_jk_full_bruteforce(Lat, eri_R, dm)
    fock_full = Lat.expand(Lat.hcore_lo_R) + vj[0] - 0.5 * vk[0]
    assert np.abs(Lat.expand(Lat.fock_lo_R) - fock_full).max() < 1e-10
    Lat.update_Ham(np.stack([dm[0], 0.5 * dm[0]]))       # unrestricted
    vj, vk = pbc_helper.get_jk_full_bruteforce(Lat, eri_R, Lat.rdm1_lo_R)
    fock_full = Lat.expand(Lat.hcore_lo_R)[None] + (vj[0] + vj[1])[None] - vk
    assert np.abs(Lat.expand(Lat.fock_lo_R) - fock_full).max() < 1e-10


BOGO_BUILDS = [
    lambda m, L: m.VcorNonLocal(False, True, L),
    lambda m, L: m.VcorRestricted(True, True, [0], [1]),
    lambda m, L: m.VcorSymm(True, True, 4, [[1, 0, 3, 2]]),
    lambda m, L: m.VcorLocalPhSymm(4.0, True, (2, 2), [0, 3], [1, 2]),
    lambda m, L: m.VcorSymmBogo(True, 4, [[1, 0, 3, 2]]),
]


@pytest.mark.parametrize("build", BOGO_BUILDS)
def test_bogoliubov_vcors_name_their_slice(build):
    """The Bogoliubov vcor families that named the GSO slice in a raise
    now build: three components, get() on seeded parameters equal to the
    JAX package's (1e-14).  The non-local one fails the JAX package's own
    assertion: a pairing vcor is local, through the GSO frame."""
    jdmet, tdmet = _pkgs()
    lat_t = tdmet.SquareLattice(4, 4, 2, 2)
    if build is BOGO_BUILDS[0]:
        with pytest.raises(AssertionError, match="GSO path"):
            build(tdmet, lat_t)
        return
    vj, vt = build(jdmet, jdmet.SquareLattice(4, 4, 2, 2)), build(tdmet, lat_t)
    assert vt.bogoliubov and vt.length() == vj.length()
    p = np.random.RandomState(3).randn(vt.length())
    vj.update(p)
    vt.update(p)
    assert np.asarray(vt.get()).shape[0] == 3
    assert np.abs(np.asarray(vt.get()) - np.asarray(vj.get())).max() < 1e-14


@pytest.mark.parametrize("spin", [1, 2])
def test_get_jk_nearest_matches_jax_and_bruteforce(spin):
    """J/K of the 'nearest' format vs the JAX package (1e-11) and, on a 2D
    mesh, vs the fully expanded supercell ERI (the JAX package's oracle
    of the same name, 1e-10)."""
    from libdmet_preview_tpu.ops import pbc_helper as jpb
    from libdmet_preview_tpu_torch.ops import pbc_helper as tpb
    _, tdmet = _pkgs()
    Lat = tdmet.SquareLattice(4, 6, 2, 1)
    nc, n = Lat.ncells, Lat.nscsites
    rng = np.random.RandomState(spin)
    eri_R = rng.randn(nc, n, n, n, n) * 0.3
    dm = rng.randn(spin, nc, n, n)
    dm = 0.5 * (dm + Lat.transpose_stripe(dm))          # Hermitian density
    vj_j, vk_j = jpb.get_jk_nearest(eri_R, dm)
    vj_t, vk_t = tpb.get_jk_nearest(eri_R, dm, CPU)
    assert np.abs(vj_t - vj_j).max() < 1e-11
    assert np.abs(vk_t - vk_j).max() < 1e-11
    vj_b, vk_b = tpb.get_jk_full_bruteforce(Lat, eri_R, dm)
    vj_bj, vk_bj = jpb.get_jk_full_bruteforce(Lat, eri_R, dm)
    assert np.abs(vj_b - vj_bj).max() < 1e-11
    assert np.abs(vk_b - vk_bj).max() < 1e-11
    assert np.abs(vj_b[:, :n, :n] - vj_t).max() < 1e-10
    # row block 0 of the full K: (0, R) blocks are the stripe's vk[R]
    assert np.abs(vk_b[:, :n].reshape(spin, n, nc, n).transpose(0, 2, 1, 3)
                  - vk_t).max() < 1e-10


def _extended_chain(dmet, **kw):
    import importlib
    ham = importlib.import_module(
        dmet.__name__.replace("dmet.hubbard", "models.hamiltonian"))
    Lat = dmet.ChainLattice(8, 1)
    Lat.set_Ham(ham.HubbardExtended(Lat, 4.0, 1.0),
                use_hcore_as_emb_ham=False, **kw)
    return Lat


@pytest.mark.parametrize("restricted", [True, False])
def test_update_ham_nearest_matches_jax(restricted):
    """update_Ham on the 'nearest' format (local J, stripe K): Fock stripe
    and its k-space pair, 1e-11, on the (U, V) chain with one site per
    cell, where the exchange has K(R) = K(-R): the JAX package builds the
    stripe from the blocks (-R, 0), the port from (R, 0) (held against
    the expanded supercell ERI in
    test_2d_mesh_negation_uses_the_cell_algebra)."""
    jdmet, tdmet = _pkgs()
    Lj, Lt = _extended_chain(jdmet), _extended_chain(tdmet, device=CPU)
    spin = 1 if restricted else 2
    rng = np.random.RandomState(7)
    dm = rng.randn(spin, Lj.ncells, 1, 1) * 0.2
    dm = 0.5 * (dm + Lj.transpose_stripe(dm))
    Lj.update_Ham(dm)
    Lt.update_Ham(dm)
    assert np.abs(Lt.fock_lo_R - Lj.fock_lo_R).max() < 1e-11
    for a, b in zip(Lt.fock_lo_k, Lj.fock_lo_k):
        assert np.abs(a - np.asarray(b)).max() < 1e-11


@pytest.mark.parametrize("restricted", [True, False])
def test_hf_with_nonlocal_vcor_matches_jax(restricted):
    """One-shot HF with a VcorNonLocal (k-resolved Hermitian potential):
    rho_R, mu, E and the doubled spectrum at 1e-8.  On a chain: both
    packages tie V(-R) to V(R)^T through (-R) % ncells of the flattened
    cell index, which is the true -R only on a 1D mesh."""
    from libdmet_preview_tpu.ops import mfd as jmfd
    from libdmet_preview_tpu_torch.ops import mfd as tmfd
    jdmet, tdmet = _pkgs()
    out = []
    for dmet, mfd, kw in ((jdmet, jmfd, {}), (tdmet, tmfd, {"device": CPU})):
        Lat = dmet.ChainLattice(16, 2)
        Lat.set_Ham(dmet.Ham(Lat, 4.0), **kw)
        v = dmet.VcorNonLocal(restricted, False, Lat, rcells=[0, 1, 2])
        v.update(np.random.RandomState(5).randn(v.length()) * 0.3)
        out.append(mfd.HF(Lat, v, 0.5, restricted, beta=20.0, ires=True))
    (rj, muj, Ej, resj), (rt, mut, Et, rest) = out
    assert np.abs(rt - np.asarray(rj)).max() < 1e-8
    assert abs(mut - muj) < 1e-8 and abs(Et - Ej) < 1e-8
    assert np.abs(rest["e"] - np.asarray(resj["e"])).max() < 1e-8


@pytest.mark.parametrize("beta", [np.inf, 50.0])
def test_hf_scf_matches_jax(beta):
    """Self-consistent lattice UHF from the AF seed on a 6 x 6 lattice:
    density, mu, E and the updated lattice Fock at 1e-8."""
    from libdmet_preview_tpu.ops import mfd as jmfd
    from libdmet_preview_tpu_torch.ops import mfd as tmfd
    jdmet, tdmet = _pkgs()
    out = []
    for dmet, mfd, kw in ((jdmet, jmfd, {}), (tdmet, tmfd, {"device": CPU})):
        Lat = dmet.SquareLattice(6, 6, 2, 2)
        Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=False, **kw)
        v = dmet.AFInitGuess((2, 2), 4.0, 0.5)
        rho, mu, E = mfd.HF_scf(Lat, v, 0.5, False, mu0=2.0, beta=beta)
        out.append((np.asarray(rho), mu, E, np.asarray(Lat.fock_lo_R)))
    for a, b in zip(out[1], out[0]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-8


def test_ghf_matches_jax():
    """Generalized HF over spin-orbitals with a pairing-like off-diagonal
    block: rho_R, mu, E, the doubled spectrum and rho(k) at 1e-8."""
    from libdmet_preview_tpu.ops import mfd as jmfd
    from libdmet_preview_tpu_torch.ops import mfd as tmfd
    jdmet, tdmet = _pkgs()
    rng = np.random.RandomState(9)
    vmat = rng.randn(3, 2, 2) * 0.4
    vmat[:2] = vmat[:2] + vmat[:2].transpose(0, 2, 1)

    class V(object):
        def get(self):
            return vmat

    out = []
    for dmet, mfd, kw in ((jdmet, jmfd, {}), (tdmet, tmfd, {"device": CPU})):
        Lat = dmet.ChainLattice(12, 2)
        Lat.set_Ham(dmet.Ham(Lat, 2.0), **kw)
        out.append(mfd.GHF(Lat, V(), 0.5, beta=30.0, ires=True))
    (rj, muj, Ej, resj), (rt, mut, Et, rest) = out
    assert np.abs(rt - np.asarray(rj)).max() < 1e-8
    assert abs(mut - muj) < 1e-8 and abs(Et - Ej) < 1e-8
    assert np.abs(rest["e"] - np.asarray(resj["e"])).max() < 1e-8
    for a, b in zip(rest["rho_k"], resj["rho_k"]):
        assert np.abs(a - np.asarray(b)).max() < 1e-8


def _three_band_one_shot(dmet, FCI, kw, fci_kw):
    Lat = dmet.Square3Band(2, 2, 1, 1)
    Lat.set_Ham(dmet.Hubbard3band_ref(Lat, name="Hanke"),
                use_hcore_as_emb_ham=True, **kw)
    vcor = dmet.VcorLocal(False, False, 3)
    vcor.update(np.zeros(vcor.length()))
    filling = 5.0 / 6.0
    rho, Mu = dmet.HartreeFock(Lat, vcor, filling, None)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=False)
    solver = FCI(restricted=False, tol=1e-11, **fci_kw)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    last_dmu = 0.0
    for _ in range(25):
        rhoEmb, E_emb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args, step=0.3)
        last_dmu += dmu
        rhoImp, E, nelec = dmet.transformResults(
            rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=False, solver=solver,
            solver_args=solver_args)
        if abs(nelec - 2 * filling) < 5e-7:
            break
    return np.asarray(rhoImp), E, nelec, last_dmu


def test_three_band_one_shot_matches_jax():
    """The three-band (Emery) one-shot DMET on Square3Band(2, 2, 1, 1),
    UHF + FCI with the dmu loop: E, nelec, dmu and the impurity density
    at 1e-7; one hole per CuO2 and the x/y oxygen symmetry as the JAX
    package's own test holds them."""
    from libdmet_preview_tpu.solvers import FCI as FCIj
    from libdmet_preview_tpu_torch.solvers import FCI as FCIt
    jdmet, tdmet = _pkgs()
    rj, Ej, nj, dj = _three_band_one_shot(jdmet, FCIj, {}, {})
    rt, Et, nt, dt = _three_band_one_shot(tdmet, FCIt, {"device": CPU},
                                          {"device": CPU})
    assert abs(Et - Ej) < 1e-7 and abs(nt - nj) < 1e-7
    assert abs(dt - dj) < 1e-7
    assert np.abs(rt - rj).max() < 1e-7
    occ = rt.sum(axis=0).diagonal()
    assert abs(nt - 5.0 / 3.0) < 1e-4
    assert abs(occ[1] - occ[2]) < 1e-3
    assert abs((2.0 - occ[0]) + (4.0 - occ[1] - occ[2]) - 1.0) < 1e-4
