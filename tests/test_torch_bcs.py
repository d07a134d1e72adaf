"""
BCS / superconducting DMET in the PyTorch port (dmet/hubbard_bcs.py, the
Bogoliubov vcor families of ops/vcor.py, spinless.FitVcorGSOEmb and
dmet/loop.run_dmet_sc) against the JAX package's, on the CPU, and the
oracles of tests/test_bcs.py on the port alone:

  * every Bogoliubov vcor family's get() and gradient() on the same
    parameters;
  * the HFB mean field: pairing appears under a pairing field and the
    physical filling holds; the d-wave sign structure on the 2D lattice;
  * the GSO vcor fit on the JAX package's embedding problem;
  * the attractive 1D SC-DMET loop converges with s-wave pairing;
    run_dmet_sc's first two iterations against the JAX package's;
  * the converged d-wave anchor of the repulsive doped 4 x 4 lattice,
    E/site -0.9352863316 at 1e-6 (the JAX suite holds the same number).

The bath's SVD gauge differs between the packages; energies, electron
counts, dmu, the fitted vcor and the impurity density are gauge-free.
"""

import itertools as it

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _quiet():
    from libdmet_preview_tpu.utils import logger as jlog
    from libdmet_preview_tpu_torch.utils import logger as tlog
    jlog.verbose = "WARNING"
    tlog.verbose = "WARNING"


# ----------------------------------------------------------------------
# the Bogoliubov vcor families
# ----------------------------------------------------------------------

VCOR_CASES = [
    ("VcorLocal", (True, True, 4), {}),
    ("VcorLocal", (True, True, 4), {"ghf": True}),
    ("VcorLocal", (False, True, 4), {"bogo_res": True}),
    ("VcorLocal", (False, True, 3), {}),
    ("VcorRestricted", (True, True, [0, 1], [2]), {}),
    ("VcorRestricted", (False, True, [0, 1], [2]), {}),
    ("VcorRestricted", (False, True, [0, 2], [1]), {"bogo_res": True}),
    ("VcorSymm", (False, True, 4, [[1, 0, 3, 2], [2, 3, 0, 1]]),
     {"spin_swap": [True, False]}),
    ("VcorSymmBogo", (True, 4, [[1, 0, 3, 2]]), {}),
    ("VcorLocalPhSymm", (4.0, True, (2, 2), [0, 3], [1, 2]), {}),
]


@pytest.mark.parametrize("name, args, kw", VCOR_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(VCOR_CASES)])
def test_bogoliubov_vcor_matches_jax(name, args, kw):
    """get() on seeded parameters and the dense gradient() against the
    JAX package's (1e-14); assign() round-trips get()."""
    import libdmet_preview_tpu.ops.vcor as jv
    import libdmet_preview_tpu_torch.ops.vcor as tv
    vj = getattr(jv, name)(*args, **kw)
    vt = getattr(tv, name)(*args, **kw)
    assert vt.bogoliubov and vt.length() == vj.length()
    p = np.random.RandomState(vj.length()).randn(vj.length())
    vj.update(p)
    vt.update(p)
    assert vt.get().shape[0] == 3
    assert np.abs(vt.get() - vj.get()).max() < 1e-14
    assert np.abs(vt.gradient() - vj.gradient()).max() < 1e-14
    if name != "VcorLocalPhSymm":       # assign() projects the shift away
        w = tv.__dict__[name](*args, **kw)
        w.assign(vt.get())
        assert np.abs(w.get() - vt.get()).max() < 1e-12


# ----------------------------------------------------------------------
# the HFB mean field
# ----------------------------------------------------------------------

def attractive_chain(pkg, L=12, nimp=2, U=-4.0):
    Lat = pkg.ChainLattice(L, nimp)
    if pkg.__name__.startswith("libdmet_preview_tpu_torch"):
        Lat.set_Ham(pkg.Ham(Lat, U), use_hcore_as_emb_ham=True, device=CPU)
    else:
        Lat.set_Ham(pkg.Ham(Lat, U), use_hcore_as_emb_ham=True)
    return Lat, pkg.GSOHam(Lat)


def onsite_pairing(vcor, nao, d):
    p = np.zeros(vcor.length())
    nV = vcor.length() - nao * (nao + 1) // 2
    for k, (i, j) in enumerate(it.combinations_with_replacement(range(nao),
                                                                2)):
        if i == j:
            p[nV + k] = d
    return p


def test_hfb_pairing_mean_field():
    """Zero vcor: normal state, kappa = 0 (1e-10).  An onsite pairing field
    of 0.5: kappa > 0.05 while the mu fit holds half filling (1e-6); the
    GSO density against the JAX package's (1e-12)."""
    from libdmet_preview_tpu.dmet import hubbard_bcs as jb
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    Lat, gham = attractive_chain(tb)
    vcor = tb.VcorSC(Lat.nscsites)
    GRho0, _, _ = tb.HartreeFockBogoliubov(gham, vcor, 0.5, mu0=-2.0)
    assert np.max(np.abs(tb.extractRdm(GRho0[0])[2])) < 1e-10
    vcor.update(onsite_pairing(vcor, 2, 0.5))
    GRho1, mu1, _ = tb.HartreeFockBogoliubov(gham, vcor, 0.5, mu0=-2.0)
    rA, rB, kap = tb.extractRdm(GRho1[0])
    assert np.max(np.abs(kap)) > 0.05
    assert abs(np.trace(rA) + np.trace(rB) - Lat.nscsites) < 1e-6
    Lj, gj = attractive_chain(jb)
    vj = jb.VcorSC(2)
    vj.update(vcor.param)
    GRhoj, muj, _ = jb.HartreeFockBogoliubov(gj, vj, 0.5, mu0=-2.0)
    assert abs(mu1 - muj) < 1e-12
    assert np.abs(GRho1 - np.asarray(GRhoj)).max() < 1e-12


def test_dwave_pairing_symmetry_hfb():
    """A d_{x2-y2} pairing field on SquareLattice(4, 4, 2, 2) at U=-2: the x
    and y bond components of kappa carry opposite signs with C4-equal
    magnitudes (1e-8), the filling holds (1e-5); against the JAX
    package's density (1e-9: the Fermi level of this 4 x 4 mesh at zero T
    is degenerate, and the levels within 1e-6 of it share their
    electrons, so eigensolver round-off in that subspace reaches 1e-10)."""
    from libdmet_preview_tpu.dmet import hubbard_bcs as jb
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.ops import spinless as ts
    nao = 4
    x_bonds, y_bonds = [(0, 2), (1, 3)], [(0, 1), (2, 3)]
    D = np.zeros((nao, nao))
    for (i, j), d in [(b, 0.4) for b in x_bonds] + [(b, -0.4)
                                                    for b in y_bonds]:
        D[i, j] = D[j, i] = d
    vmat = ts.combine_vcor([np.zeros((nao, nao))] * 2 + [D])
    out = []
    for pkg in (tb, jb):
        Lat = pkg.SquareLattice(4, 4, 2, 2)
        kw = {"device": CPU} if pkg is tb else {}
        Lat.set_Ham(pkg.Ham(Lat, -2.0), use_hcore_as_emb_ham=True, **kw)
        GRho, mu, _ = pkg.GHartreeFock(pkg.GSOHam(Lat), 0.5, mu0=-1.0,
                                       vcor_mat=vmat)
        out.append(np.asarray(GRho))
    rA, rB, kap = ts.extract_rdm(out[0][0])
    kx = np.mean([kap[i, j] for i, j in x_bonds])
    ky = np.mean([kap[i, j] for i, j in y_bonds])
    assert abs(kx) > 0.01 and abs(ky) > 0.01
    assert kx * ky < 0
    assert abs(abs(kx) - abs(ky)) < 1e-8
    assert abs(np.trace(rA) + np.trace(rB) - nao) < 1e-5
    assert np.abs(out[0] - out[1]).max() < 1e-9


# ----------------------------------------------------------------------
# the GSO vcor fit
# ----------------------------------------------------------------------

def test_fit_vcor_gso_emb_matches_jax():
    """FitVcorGSOEmb on the JAX package's embedding problem (its bath, its
    FCI(ghf) density, an onsite pairing vcor): 20 CG steps give the JAX
    package's parameters and error (1e-10).  The CG path of this fit is
    chaotic: round-off of 1e-16 grows to 1e-9 by step 40 in either
    package, and the two stop at different points of a flat valley, so
    the full fit is held to the error the JAX package reaches (1e-3) and
    to a lower error than its start."""
    from libdmet_preview_tpu.dmet import hubbard_bcs as jb
    from libdmet_preview_tpu.solvers import FCI as JFCI
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.ops import spinless as ts
    Lj, gj = attractive_chain(jb)
    vj = jb.VcorSC(2)
    vj.update(onsite_pairing(vj, 2, 0.2))
    vmat = ts.combine_vcor(vj.get())
    GRho, mu, _ = jb.GHartreeFock(gj, 0.5, mu0=-2.0, vcor_mat=vmat)
    ImpHam, _, basis = jb.ConstructImpHam(gj, GRho, mu, vcor_mat=vmat)
    rdm, _ = JFCI(restricted=True, ghf=True, tol=1e-12).run(ImpHam, nelec=4)
    Lt, gt = attractive_chain(tb)
    basis_t = torch.as_tensor(np.asarray(basis))
    out = {}
    for n in (0, 20, 200):
        v_fit, err = jb.FitVcor(rdm, Lj, basis, vj, gj, mu, MaxIter=n)
        vt = interop.vcor_local_from_numpy(True, 2, vj.param,
                                           bogoliubov=True)
        vt_fit, err_t = tb.FitVcor(np.asarray(rdm), Lt, basis_t, vt, gt, mu,
                                   MaxIter=n)
        assert np.abs(vt.param - vj.param).max() == 0.0   # input untouched
        out[n] = (err, err_t, np.abs(vt_fit.param - v_fit.param).max())
    for n in (0, 20):
        err, err_t, dp = out[n]
        assert abs(err_t - err) < 1e-10 and dp < 1e-10, n
    err, err_t, _ = out[200]
    assert abs(err_t - err) < 1e-3
    assert err_t < out[20][1] < out[0][1]


# ----------------------------------------------------------------------
# the SC-DMET loop
# ----------------------------------------------------------------------

def test_sc_dmet_attractive_hubbard_converges():
    """The hand-written SC-DMET loop of tests/test_bcs.py on the port:
    attractive 1D Hubbard at half filling converges with s-wave pairing
    (nelec 1e-5, |kappa| > 0.05, E < 0)."""
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.ops import spinless as ts
    from libdmet_preview_tpu_torch.ops.diis import DIIS
    from libdmet_preview_tpu_torch.solvers import FCI
    _quiet()
    Lat, gham = attractive_chain(tb)
    vcor = tb.VcorSC(2)
    vcor.update(onsite_pairing(vcor, 2, 0.2))
    solver = FCI(restricted=True, ghf=True, tol=1e-11, device=CPU)
    adiis = DIIS(space=4)
    E_old, conv, mu = 0.0, False, -2.0
    for i in range(20):
        vmat = ts.combine_vcor(vcor.get())
        GRho, mu, _ = tb.GHartreeFock(gham, 0.5, mu0=mu, vcor_mat=vmat)
        ImpHam, _, basis = tb.ConstructImpHam(gham, GRho, mu, vcor_mat=vmat)
        rdm, E_emb, ImpHam_d, dmu = tb.SolveImpHam_with_fitting(
            gham, 0.5, ImpHam, basis, solver, thrnelec=1e-7)
        GRhoImp, Efrag, n = tb.transformResults(rdm, E_emb, basis, ImpHam_d,
                                                gham, mu, last_dmu=dmu)
        vcor_new, _ = tb.FitVcor(rdm, Lat, basis, vcor, gham, mu,
                                 MaxIter=200)
        pvcor = adiis.update(vcor_new.param) if i >= 3 else vcor_new.param
        dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
        vcor.update(pvcor)
        dE, E_old = Efrag - E_old, Efrag
        if dV < 1e-5 and abs(dE) < 1e-6 and i > 3:
            conv = True
            break
    kap = tb.extractRdm(GRhoImp)[2]
    assert conv
    assert abs(n - 1.0) < 1e-5
    assert float(torch.max(torch.abs(kap))) > 0.05
    assert E_old < 0.0


def test_run_dmet_sc_two_iterations_match_jax():
    """run_dmet_sc on the attractive chain (tests/test_bcs.py
    test_run_dmet_sc_driver), two iterations in both packages: E and nelec
    of each iteration, the accumulated dmu and the vcor 1e-8."""
    from libdmet_preview_tpu.dmet import hubbard_bcs as jb
    from libdmet_preview_tpu.dmet.loop import run_dmet_sc as jrun
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet_sc
    _quiet()
    out = []
    for pkg, run in ((jb, jrun), (tb, run_dmet_sc)):
        Lat, _ = attractive_chain(pkg)
        vcor = pkg.VcorSC(2)
        vcor.update(onsite_pairing(vcor, 2, 0.2))
        out.append(run(Lat, vcor, 0.5, mu0=-2.0, max_iter=2))
    j, t = out
    assert len(t.history) == len(j.history) == 2
    for hj, ht in zip(j.history, t.history):
        assert abs(ht["E"] - hj["E"]) < 1e-8
        assert abs(ht["nelec"] - hj["nelec"]) < 1e-8
    assert abs(t.last_dmu - j.last_dmu) < 1e-8
    assert abs(t.mu - j.mu) < 1e-8
    assert np.abs(t.vcor.param - j.vcor.param).max() < 1e-8


def test_run_dmet_sc_dwave_anchor():
    """The repulsive doped d-wave SC-DMET on SquareLattice(4, 4, 2, 2), U=4,
    filling 0.4375, converged on the port alone: E/site -0.9352863316
    (1e-6), |kappa_x| 0.0952150 (1e-4), d-wave signs, C4-equal magnitudes
    (1e-5), nelec (1e-4)."""
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as tb
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet_sc
    _quiet()
    U, filling, nao = 4.0, 0.4375, 4
    Lat = tb.SquareLattice(4, 4, 2, 2)
    Lat.set_Ham(tb.Ham(Lat, U), use_hcore_as_emb_ham=True, device=CPU)
    vcor = tb.VcorSC(nao)
    p0 = np.zeros(vcor.length())
    nV = nao * (nao + 1) // 2
    x_bonds, y_bonds = [(0, 2), (1, 3)], [(0, 1), (2, 3)]
    for idx, (i, j) in enumerate(it.combinations_with_replacement(
            range(nao), 2)):
        if i == j:
            p0[idx] = U * filling
        if (i, j) in x_bonds:
            p0[nV + idx] = 0.1
        if (i, j) in y_bonds:
            p0[nV + idx] = -0.1
    vcor.update(p0)
    res = run_dmet_sc(Lat, vcor, filling, max_iter=20, mu0=U * filling,
                      mixing=0.5, diis_start=10, conv_tol_E=1e-7,
                      conv_tol_vcor=1e-6, thrnelec=1e-6)
    kap = tb.extractRdm(res.rho_imp)[2]
    kx = np.mean([kap[i, j] for i, j in x_bonds])
    ky = np.mean([kap[i, j] for i, j in y_bonds])
    assert res.converged
    assert abs(res.e_per_site - (-0.9352863316)) < 1e-6
    assert abs(abs(kx) - 0.0952150) < 1e-4
    assert kx * ky < 0
    assert abs(abs(kx) - abs(ky)) < 1e-5
    assert abs(res.nelec_imp - 2 * filling) < 1e-4
