"""
The GSO / spinless formalism of the PyTorch port
(libdmet_preview_tpu_torch/ops/spinless.py, dmet/hubbard_gso.py,
lo/scdm.py, the ghf branches of solvers/fci.py, solvers/scf.py's GSO
mean field, ops/pbc_helper.get_jk_ghf) against the JAX package's, on the
CPU, on the same seeded NumPy inputs; and the port's own oracles of
tests/test_gso.py.

The bath is an SVD of the environment block, whose column signs and
rotation differ between NumPy and torch, so the comparisons are of
gauge-free quantities: energies, electron counts, the bath projector, the
impurity block of densities (the impurity columns are the identity) and
spectra.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def ring_hubbard(nao=4, U=3.0):
    h = np.zeros((nao, nao))
    for i in range(nao):
        h[i, (i + 1) % nao] = h[(i + 1) % nao, i] = -1.0
    g = np.zeros((nao,) * 4)
    for i in range(nao):
        g[i, i, i, i] = U
    return h, g


def gso_integral(sp, h, g, mu, with_mu=True):
    """The ph-transformed spinless Integral of the Hubbard cluster (h, g)
    through the package `sp` (either package's ops.spinless), as NumPy
    blocks; with_mu adds mu_matrix(mu) to H1 and -mu*nao to H0."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    nao = h.shape[0]
    nso = 2 * nao
    GH1_c, GH0 = sp.transform_H1_k((h[None], np.zeros_like(h)[None]))
    GH1 = sp.combine_H1_k(GH1_c)
    GV2, GV1, GV0 = sp.transform_H2_local(g)
    H1_so = GH1[0][0].copy()
    H1_so[:nao, :nao] += GV1[0]
    H1_so[nao:, nao:] += GV1[1]
    H0 = GH0 + GV0
    if with_mu:
        H1_so += sp.mu_matrix(mu, nao)
        H0 -= mu * nao
    eye = np.eye(nso).reshape(1, nso, nso)
    if sp.__name__.startswith("libdmet_preview_tpu_torch"):
        eye = torch.as_tensor(eye)
    g_so = _np(sp.transform_eri_local_gso(eye[:, :nao, :], eye[:, nao:, :],
                                          GV2))
    return Integral(nso, True, False, H0, {"cd": H1_so[None]},
                    {"ccdd": g_so[None]})


# ----------------------------------------------------------------------
# module 1: the transforms, each against the JAX package
# ----------------------------------------------------------------------

def _transform_case(name, rng):
    """(JAX output, port output) of one transform on seeded inputs."""
    from libdmet_preview_tpu.ops import spinless as js
    from libdmet_preview_tpu_torch.ops import spinless as ts
    nk, nao = 3, 3
    pair = (rng.randn(3, nk, nao, nao), rng.randn(3, nk, nao, nao))
    A = rng.randn(6, nao, nao)
    A = A + A.transpose(0, 2, 1)
    g = np.einsum("xpq, xrs -> pqrs", A, A)
    if name == "transform_H1_k":
        (j, j0), (t, t0) = js.transform_H1_k(pair), ts.transform_H1_k(pair)
        return [*j, j0], [*t, t0]
    if name == "combine_H1_k":
        return js.combine_H1_k(pair), ts.combine_H1_k(pair)
    if name == "transform_H2_local":
        (a, b, c), (d, e, f) = (js.transform_H2_local(g),
                                ts.transform_H2_local(g))
        return [a, b, c], [d, e, f]
    if name == "get_GV1_GV0_from_chol":
        j1, j0 = js.get_GV1_GV0_from_chol(A)
        t1, t0 = ts.get_GV1_GV0_from_chol(torch.as_tensor(A))
        return [j1, j0], [t1, t0]
    if name == "get_veff_ghf":
        dm = rng.randn(nao, nao)
        dm = dm + dm.T
        return (js.get_veff_ghf(dm, g),
                ts.get_veff_ghf(torch.as_tensor(dm), torch.as_tensor(g)))
    if name == "transform_rdm1_k":
        return js.transform_rdm1_k(pair), ts.transform_rdm1_k(pair)
    if name == "extract_rdm":
        G = rng.randn(2 * nao, 2 * nao)
        return js.extract_rdm(G), ts.extract_rdm(torch.as_tensor(G))
    if name == "mu_matrix / n_phys / combine_vcor":
        v3 = rng.randn(3, nao, nao)
        return ([js.mu_matrix(0.7, nao), js.n_phys_from_GRho(1.2, 0.4, nao),
                 js.combine_vcor(v3)],
                [ts.mu_matrix(0.7, nao), ts.n_phys_from_GRho(1.2, 0.4, nao),
                 ts.combine_vcor(v3)])
    if name == "transform_eri_local_gso":
        B = rng.randn(2, 2 * nao, 5)
        GV2 = np.asarray([g, 0.5 * g, -g])
        return (js.transform_eri_local_gso(B[:, :nao], B[:, nao:], GV2),
                ts.transform_eri_local_gso(torch.as_tensor(B[:, :nao]),
                                           torch.as_tensor(B[:, nao:]), GV2))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "transform_H1_k", "combine_H1_k", "transform_H2_local",
    "get_GV1_GV0_from_chol", "get_veff_ghf", "transform_rdm1_k",
    "extract_rdm", "mu_matrix / n_phys / combine_vcor",
    "transform_eri_local_gso"])
def test_transform_matches_jax(name):
    """Each transform of ops/spinless.py against the JAX package's: 1e-12
    relative to the largest entry."""
    jout, tout = _transform_case(name, np.random.RandomState(7))
    if not isinstance(jout, (list, tuple)):
        jout, tout = [jout], [tout]
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        a, b = np.asarray(a, dtype=float), _np(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max())


# ----------------------------------------------------------------------
# the particle-hole transform, FCI(ghf=True), CCSD(ghf=True)
# ----------------------------------------------------------------------

def test_ph_transform_exact():
    """FCI of the transformed spinless 4-site ring at N_T = nao equals the
    physical FCI at half filling minus mu*N (port alone, 1e-9)."""
    from libdmet_preview_tpu_torch.models.integral import Integral
    from libdmet_preview_tpu_torch.ops import spinless as ts
    from libdmet_preview_tpu_torch.solvers import FCI
    h, g = ring_hubbard()
    nao, mu = 4, 1.5
    Ham = Integral(nao, True, False, 0.0, {"cd": h[None]}, {"ccdd": g[None]})
    _, E_phys = FCI(restricted=True, tol=1e-12, device=CPU).run(Ham,
                                                                 nelec=nao)
    GHam = gso_integral(ts, h, g, mu)
    rdm, E_T = FCI(restricted=True, ghf=True, tol=1e-12,
                   device=CPU).run(GHam, nelec=nao)
    assert rdm.shape == (1, 2 * nao, 2 * nao)
    assert abs(E_T - (E_phys - mu * nao)) < 1e-9


def jax_gso_problem():
    """A GSO embedding problem of the JAX package: ChainLattice(12, 2),
    U=4, half filling, fixed AFM vcor, NIB (neo = 8, 4 particles)."""
    from libdmet_preview_tpu.dmet import hubbard_gso as jg
    from libdmet_preview_tpu.ops import spinless as js
    Lat = jg.ChainLattice(12, 2)
    Lat.set_Ham(jg.Ham(Lat, 4.0), use_hcore_as_emb_ham=True)
    gham = jg.GSOHam(Lat)
    va, vb = afm_vcor(2, 0.5)
    vmat = js.combine_vcor([va, vb, np.zeros_like(va)])
    GRho, mu, _ = jg.GHartreeFock(gham, 0.5, mu0=2.0, vcor_mat=vmat)
    ImpHam, _, basis = jg.ConstructImpHam(gham, GRho, mu, vcor_mat=vmat)
    return ImpHam, basis


def test_fci_ghf_matches_jax():
    """FCI(ghf=True) on the JAX package's GSO embedding Hamiltonian: E and
    rdm1 against the JAX solver at 1e-10; run_dmet_ham reproduces E."""
    from libdmet_preview_tpu.solvers import FCI as JFCI
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.solvers import FCI
    ImpHam, basis = jax_gso_problem()
    neo = basis.shape[-1]
    rdm, E = JFCI(restricted=True, ghf=True, tol=1e-12).run(ImpHam,
                                                            nelec=neo // 2)
    Ham_t = interop.integral_from_numpy(
        neo, True, ImpHam.H0, ImpHam.H1["cd"], ImpHam.H2["ccdd"], CPU)
    solver = FCI(restricted=True, ghf=True, tol=1e-12, device=CPU)
    rdm_t, E_t = solver.run(Ham_t, nelec=neo // 2)
    assert solver.nelec == (neo // 2, 0)
    assert abs(E_t - E) < 1e-10
    assert np.abs(_np(rdm_t) - np.asarray(rdm)).max() < 1e-10
    assert abs(solver.run_dmet_ham(Ham_t) - E_t) < 1e-10


def test_ccsd_ghf_equals_fci_ghf():
    """CCSD(ghf=True) on the ph-transformed 2-site Hubbard dimer (a
    2-particle problem, where CCSD is exact) equals FCI(ghf=True): E 1e-9,
    rdm1 1e-7, and run_dmet_ham reproduces E."""
    from libdmet_preview_tpu_torch.ops import spinless as ts
    from libdmet_preview_tpu_torch.solvers import CCSD, FCI
    h, g = ring_hubbard(nao=2)
    GHam = gso_integral(ts, h, g, 1.5)
    rdm_f, E_f = FCI(restricted=True, ghf=True, tol=1e-12,
                     device=CPU).run(GHam, nelec=2)
    cc = CCSD(ghf=True, tol=1e-11, device=CPU)
    rdm_c, E_c = cc.run(GHam, nelec=2)
    assert abs(E_c - E_f) < 1e-9
    assert np.abs(_np(rdm_c) - _np(rdm_f)).max() < 1e-7
    assert abs(cc.run_dmet_ham(GHam) - E_f) < 1e-8


# ----------------------------------------------------------------------
# one-shot GSO DMET == UHF DMET; the SCDM bath
# ----------------------------------------------------------------------

def afm_vcor(nao_imp, m):
    """Fixed AFM staggered potential [va, vb] (gapped at half filling)."""
    stag = np.diag([(-1.0) ** i for i in range(nao_imp)])
    return np.asarray([m * stag, -m * stag])


def port_chain(L, nimp, U):
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    Lat = tdmet.ChainLattice(L, nimp)
    Lat.set_Ham(tdmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=CPU)
    return Lat


def test_gso_one_shot_equals_uhf():
    """Half filling with a fixed AFM vcor (gapped): the port's one-shot
    GSO-DMET equals its spin-unrestricted DMET, 1e-6 (tests/test_gso.py
    test_gso_1shot_equals_uhf)."""
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import spinless as ts
    from libdmet_preview_tpu_torch.solvers import FCI
    L, nimp, U, filling, m = 12, 2, 4.0, 0.5, 0.5

    Lat = port_chain(L, nimp, U)
    vcor = tdmet.VcorLocal(False, False, nimp)
    vcor.assign(afm_vcor(nimp, m))
    rho, _, _ = tdmet.HartreeFock(Lat, vcor, filling, U * filling, ires=True)
    ImpHam, H1e, basis = tdmet.ConstructImpHam(Lat, rho, vcor,
                                               matching=False)
    solver = FCI(restricted=False, tol=1e-12, device=CPU)
    mu_solver = tdmet.MuSolver(adaptive=True)
    args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    last_dmu = 0.0
    for _ in range(12):
        rhoEmb, EEmb, ImpHam, dmu = mu_solver(Lat, filling, ImpHam, basis,
                                              solver, args, step=0.4)
        last_dmu += dmu
        _, E_uhf, n_uhf = tdmet.transformResults(
            rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, solver=solver, solver_args=args)
        if abs(n_uhf - 2 * filling) < 1e-6:
            break

    Lat2 = port_chain(L, nimp, U)
    gham = tg.GSOHam(Lat2)
    va, vb = afm_vcor(nimp, m)
    vmat = ts.combine_vcor([va, vb, np.zeros_like(va)])
    GRho, mu, _ = tg.GHartreeFock(gham, filling, mu0=U * filling,
                                  vcor_mat=vmat)
    gImpHam, _, gbasis = tg.ConstructImpHam(gham, GRho, mu, vcor_mat=vmat)
    gsolver = FCI(restricted=True, ghf=True, tol=1e-12, device=CPU)
    rdm, E_emb, gImpHam_d, gdmu = tg.SolveImpHam_with_fitting(
        gham, filling, gImpHam, gbasis, gsolver, thrnelec=1e-7)
    _, E_gso, n_gso = tg.transformResults(rdm, E_emb, gbasis, gImpHam_d,
                                          gham, mu, last_dmu=gdmu)
    assert abs(n_uhf - 2 * filling) < 1e-5
    assert abs(n_gso - 2 * filling) < 1e-5
    assert abs(E_gso - E_uhf) < 1e-6


def test_gso_one_shot_matches_jax():
    """The one-shot GSO pipeline (GHartreeFock -> ConstructImpHam ->
    SolveImpHam_with_fitting -> transformResults) in both packages: mu,
    GRho_R 1e-12; bath projector, H1 spectrum 1e-10; E, nelec, dmu, the
    impurity GSO density 1e-8."""
    from libdmet_preview_tpu.dmet import hubbard_gso as jg
    from libdmet_preview_tpu.solvers import FCI as JFCI
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import spinless as ts
    from libdmet_preview_tpu_torch.solvers import FCI
    L, nimp, U, filling = 12, 2, 4.0, 0.4
    va, vb = afm_vcor(nimp, 0.5)
    vmat = ts.combine_vcor([va, vb, 0.1 * np.ones_like(va)])
    out = []
    for pkg, lat, solver in [
            (jg, None, JFCI(restricted=True, ghf=True, tol=1e-12)),
            (tg, port_chain(L, nimp, U),
             FCI(restricted=True, ghf=True, tol=1e-12, device=CPU))]:
        if lat is None:
            lat = jg.ChainLattice(L, nimp)
            lat.set_Ham(jg.Ham(lat, U), use_hcore_as_emb_ham=True)
        gham = pkg.GSOHam(lat)
        GRho, mu, _ = pkg.GHartreeFock(gham, filling, mu0=U * filling,
                                       vcor_mat=vmat)
        ImpHam, _, basis = pkg.ConstructImpHam(gham, GRho, mu,
                                               vcor_mat=vmat)
        rdm, E_emb, Ham_d, dmu = pkg.SolveImpHam_with_fitting(
            gham, filling, ImpHam, basis, solver, thrnelec=1e-9)
        GImp, E, n = pkg.transformResults(rdm, E_emb, basis, Ham_d, gham, mu,
                                          last_dmu=dmu)
        B = _np(basis).reshape(-1, basis.shape[-1])
        out.append({"mu": mu, "GRho": _np(GRho), "P": B @ B.T,
                    "ev": np.linalg.eigvalsh(_np(ImpHam.H1["cd"])[0]),
                    "E": E, "n": n, "dmu": dmu, "GImp": _np(GImp)})
    j, t = out
    assert abs(t["mu"] - j["mu"]) < 1e-12
    assert np.abs(t["GRho"] - j["GRho"]).max() < 1e-12
    assert np.abs(t["P"] - j["P"]).max() < 1e-10
    assert np.abs(t["ev"] - j["ev"]).max() < 1e-10
    for k in ("E", "n", "dmu"):
        assert abs(t[k] - j[k]) < 1e-8, k
    assert np.abs(t["GImp"] - j["GImp"]).max() < 1e-8


def test_scdm_bath_invariance_and_scdm_matches_jax():
    """SCDM rotates the bath block only: orthonormal, the same span
    (1e-9), more local; lo.scdm on the same columns equals the JAX
    package's (1e-12)."""
    from libdmet_preview_tpu.lo.scdm import scdm as jscdm
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.lo.scdm import scdm
    from libdmet_preview_tpu_torch.ops import spinless as ts
    Lat = port_chain(12, 2, 4.0)
    gham = tg.GSOHam(Lat)
    GRho, _, _ = tg.GHartreeFock(gham, 0.5, mu0=2.0)
    b0 = _np(ts.get_emb_basis(Lat, GRho))
    b1 = _np(ts.get_emb_basis(Lat, GRho, localize_bath="scdm"))
    B0 = b0.reshape(-1, b0.shape[-1])
    B1 = b1.reshape(-1, b1.shape[-1])
    assert np.max(np.abs(B1.T @ B1 - np.eye(B1.shape[1]))) < 1e-9
    assert np.max(np.abs(B0 @ B0.T - B1 @ B1.T)) < 1e-9
    half = b0.shape[-1] // 2
    assert np.max(np.abs(b1[0, :, :, half:])) \
        > np.max(np.abs(b0[0, :, :, half:])) - 1e-9
    u = B0[4:, 4:]
    assert np.abs(scdm(u) - jscdm(u)).max() < 1e-12


# ----------------------------------------------------------------------
# the GSO mean field: GHF_mu_fit, GKS_mu_fit
# ----------------------------------------------------------------------

@pytest.mark.parametrize("filling, beta", [(0.4, np.inf), (0.4, 50.0),
                                           (0.5, np.inf)])
def test_ghf_mu_fit_matches_jax(filling, beta):
    """GHF_mu_fit with a pairing vcor on ChainLattice(12, 2): mu, GRho_R
    and the mean-field E against the JAX package's (1e-12 at zero T; at
    finite T the Fermi level is searched on the device, not by brentq:
    1e-10)."""
    from libdmet_preview_tpu.dmet import hubbard_gso as jg
    from libdmet_preview_tpu.ops import spinless as js
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import spinless as ts
    va, vb = afm_vcor(2, 0.3)
    vmat = js.combine_vcor([va, vb, np.asarray([[0.2, 0.05], [0.05, 0.2]])])
    lat_j = jg.ChainLattice(12, 2)
    lat_j.set_Ham(jg.Ham(lat_j, 4.0), use_hcore_as_emb_ham=True)
    gj = jg.GSOHam(lat_j)
    gt = tg.GSOHam(port_chain(12, 2, 4.0))
    G, mu, res = js.GHF_mu_fit(lat_j, gj.GH1_k, vmat, filling, mu0=0.0,
                               beta=beta)
    Gt, mut, rest = ts.GHF_mu_fit(gt.lattice, gt.GH1_k, vmat, filling,
                                  mu0=0.0, beta=beta)
    tol = 1e-12 if beta == np.inf else 1e-10
    assert Gt.shape == np.shape(G)
    assert abs(mut - mu) < tol
    assert np.abs(Gt - np.asarray(G)).max() < tol
    assert abs(rest["E"] - res["E"]) < tol
    assert abs(rest["nelec_phys"] - res["nelec_phys"]) < 1e-9


def test_gks_mu_fit_matches_jax():
    """GKS_mu_fit: xc_eval=None is GHF_mu_fit exactly (1e-12); with a
    staggered Hartree-like functional at beta=50 it converges, holds the
    physical filling (1e-6) and equals the JAX package's (1e-9)."""
    from libdmet_preview_tpu.dmet import hubbard_gso as jg
    from libdmet_preview_tpu.ops import spinless as js
    from libdmet_preview_tpu_torch.dmet import hubbard_gso as tg
    from libdmet_preview_tpu_torch.ops import spinless as ts
    gt = tg.GSOHam(port_chain(12, 2, 4.0))
    nao = 2
    G0, _, _ = ts.GHF_mu_fit(gt.lattice, gt.GH1_k, np.zeros((4, 4)), 0.4,
                             mu0=0.0, beta=50.0)
    G1, _, r1 = ts.GKS_mu_fit(gt.lattice, gt.GH1_k, 0.4, None, mu0=0.0,
                              beta=50.0)
    assert r1["cycles"] == 1
    assert np.abs(G1 - G0).max() < 1e-12

    stag = np.diag([1.0, -1.0])

    def xc_eval(rA, rB):
        return (0.5 * stag * np.diag(np.diag(rB)),
                0.5 * stag * np.diag(np.diag(rA)))

    kw = dict(mu0=0.0, conv_tol=1e-9, mix=0.4, max_cycle=200, beta=50.0)
    G2, mu2, r2 = ts.GKS_mu_fit(gt.lattice, gt.GH1_k, 0.4, xc_eval, **kw)
    assert r2["dGRho"] < 1e-9
    rA, rB, _ = ts.extract_rdm(G2[0])
    assert abs(np.trace(rA) + np.trace(rB) - 0.4 * 2 * nao) < 1e-6
    assert np.abs(G2 - G0).max() > 1e-3
    lat_j = jg.ChainLattice(12, 2)
    lat_j.set_Ham(jg.Ham(lat_j, 4.0), use_hcore_as_emb_ham=True)
    gj = jg.GSOHam(lat_j)
    Gj, muj, rj = js.GKS_mu_fit(lat_j, gj.GH1_k, 0.4, xc_eval, **kw)
    assert r2["cycles"] == rj["cycles"]
    assert abs(mu2 - muj) < 1e-9
    assert np.abs(G2 - np.asarray(Gj)).max() < 1e-9


# ----------------------------------------------------------------------
# the GSO SCF (GGHF, GGHF_mu) and get_jk_ghf
# ----------------------------------------------------------------------

def test_gghf_and_gghf_mu_match_jax():
    """GGHF and GGHF_mu on the ph-transformed 4-site ring (mu not folded
    into H1) from the UHF AFM density: E, rho, mu against the JAX
    package's (1e-9); the fit holds the transformed and the physical
    counts; the identity-basis route is the same fit."""
    from libdmet_preview_tpu.ops import spinless as js
    from libdmet_preview_tpu.solvers.scf import GGHF as JGGHF
    from libdmet_preview_tpu.solvers.scf import GGHF_mu as JGGHF_mu
    from libdmet_preview_tpu_torch.solvers.scf import GGHF, GGHF_mu
    h, g = ring_hubbard()
    nao, nso = 4, 8
    GHam = gso_integral(js, h, g, 0.0, with_mu=False)
    GRho0 = np.zeros((nso, nso))
    for i in range(nao):
        GRho0[i, i] = 0.5 + 0.4 * (-1) ** i
        GRho0[nao + i, nao + i] = 1.0 - (0.5 - 0.4 * (-1) ** i)
    v_mu = js.mu_matrix(1.5, nao)
    E, rho, _, _ = JGGHF(GHam, nao, dm0=GRho0, tol=1e-12, v_ext=v_mu)
    Et, rhot, _, _ = GGHF(GHam, nao, dm0=GRho0, tol=1e-12, v_ext=v_mu,
                          device=CPU)
    assert abs(Et - E) < 1e-9
    assert np.abs(rhot - rho).max() < 1e-9
    E, rho, _, _, mu = JGGHF_mu(GHam, nao, nao, mu0=1.5, dm0=GRho0,
                                tol=1e-12)
    Et, rhot, _, _, mut = GGHF_mu(GHam, nao, nao, mu0=1.5, dm0=GRho0,
                                  tol=1e-12, device=CPU)
    assert abs(Et - E) < 1e-9
    assert abs(mut - mu) < 1e-9
    assert np.abs(rhot - rho).max() < 1e-9
    assert abs(np.trace(rhot) - nao) < 1e-8
    n_phys = np.trace(rhot[:nao, :nao]) - np.trace(rhot[nao:, nao:]) + nao
    assert abs(n_phys - nao) < 1e-6
    eye_basis = np.eye(nso).reshape(1, nso, nso)
    E2, rho2, _, _, _ = GGHF_mu(GHam, nao, nao, mu0=1.5, dm0=GRho0,
                                basis=eye_basis, tol=1e-12, device=CPU)
    assert abs(E2 - Et) < 1e-9
    assert np.abs(rho2 - rhot).max() < 1e-7


def test_get_jk_ghf_matches_jax():
    """get_jk_ghf on seeded spin-blocked ERIs and a generalized density:
    against the JAX package's (1e-12); J and K are Hermitian."""
    from libdmet_preview_tpu.ops.pbc_helper import get_jk_ghf as jjk
    from libdmet_preview_tpu_torch.ops.pbc_helper import get_jk_ghf
    rng = np.random.RandomState(3)
    n = 3
    A = rng.randn(3, 5, n, n)
    A = A + A.transpose(0, 1, 3, 2)
    g_aa = np.einsum("xpq, xrs -> pqrs", A[0], A[0])
    g_bb = np.einsum("xpq, xrs -> pqrs", A[1], A[1])
    g_ab = np.einsum("xpq, xrs -> pqrs", A[0], A[1])
    dm = rng.randn(2 * n, 2 * n)
    dm = dm + dm.T
    vj, vk = jjk((g_aa, g_bb, g_ab), dm)
    vjt, vkt = get_jk_ghf((g_aa, g_bb, g_ab), dm, device=CPU)
    assert np.abs(_np(vjt) - vj).max() < 1e-12
    assert np.abs(_np(vkt) - vk).max() < 1e-12
    assert np.abs(_np(vkt) - _np(vkt).T).max() < 1e-12


# ----------------------------------------------------------------------
# defaults and imports
# ----------------------------------------------------------------------

def test_gso_entry_points_default_to_cuda():
    """FCI(ghf=True) and every Bogoliubov vcor family build without a
    Slice message; the solver's device and the lattice's (which
    run_dmet_sc follows) are the card by default."""
    import inspect
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.ops import vcor as tv
    from libdmet_preview_tpu_torch.solvers import FCI
    solver = FCI(restricted=True, ghf=True)
    assert solver.device == torch.device("cuda")
    for v in [tb.VcorSC(4), tv.VcorLocal(False, True, 4, bogo_res=True),
              tv.VcorRestricted(False, True, [0, 1], [2]),
              tv.VcorSymm(True, True, 4, [[1, 0, 3, 2]]),
              tv.VcorSymmBogo(False, 4, [[1, 0, 3, 2]]),
              tv.VcorLocalPhSymm(4.0, True, (2, 2), [0, 3], [1, 2])]:
        assert v.bogoliubov and v.get().shape[0] == 3
    lat = tb.ChainLattice(4, 2)
    assert inspect.signature(lat.set_Ham).parameters["device"].default \
        == torch.device("cuda")
    with pytest.raises(AssertionError, match="GSO path"):
        tv.VcorNonLocal(True, True, lat)
    for root, _, files in os.walk(os.path.join(REPO,
                                               "libdmet_preview_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                assert "Slice 4" not in open(os.path.join(root, f)).read(), f

