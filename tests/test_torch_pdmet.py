"""
The slice as a whole on the CPU: hand-written DMET loops over the port's
entry points against the same loops over the JAX package.

  * pDMET (global-density-matrix self-consistency, no vcor fit) on a
    12 x 12 Hubbard lattice, U = 4, beta = 1000, UHF + FCI, interacting
    bath, three iterations, with the Fock update and with the idempotent
    projection (the loops of the JAX package's tests/test_pdmet.py): E,
    nelec, dmu and the global density at 1e-7.
  * The finite-temperature Fock-embedding loop with the whole-lattice
    vcor fit (tests/test_dmet_hub2d.py::test_hub2d_ib_fock) on its 6 x 6
    lattice: two iterations, each port iteration started from the JAX
    loop's vcor, at 1e-6.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mods(port):
    if port:
        import libdmet_preview_tpu_torch.dmet.hubbard as dmet
        from libdmet_preview_tpu_torch.ops import embham, mfd
        from libdmet_preview_tpu_torch.ops.diis import DIIS
        from libdmet_preview_tpu_torch.solvers import FCI
        return dmet, embham, mfd, DIIS, FCI, {"device": CPU}
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops import embham, mfd
    from libdmet_preview_tpu.ops.diis import DIIS
    from libdmet_preview_tpu.solvers import FCI
    return dmet, embham, mfd, DIIS, FCI, {}


def _pdmet(port, idem, size=(12, 12), niter=3):
    dmet, embham, mfd, DIIS, FCI, kw = _mods(port)
    U, Filling, beta = 4.0, 0.5, 1000.0
    Lat = dmet.SquareLattice(*size, 2, 2)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=False, **kw)
    vcor_seed = dmet.AFInitGuess((2, 2), U, Filling)
    rho, Mu, E, res = mfd.HF_scf(Lat, vcor_seed, Filling, False,
                                 mu0=U * Filling, beta=beta, ires=True)
    vcor = dmet.VcorLocal(False, False, Lat.nscsites)
    vcor.update(np.zeros(vcor.length()))
    nsc = Lat.nscsites
    solver = FCI(restricted=False, tol=1e-12, **kw)
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=6)
    rho_glob = np.asarray(rho)
    last_dmu = 0.0
    rec = []
    for it in range(niter):
        Lat.update_Ham(rho_glob)
        if idem:
            rho_bath = rho_glob
        else:
            rho_bath, Mu = dmet.HartreeFock(Lat, vcor, Filling, Mu, beta=beta)
            rho_bath = np.asarray(rho_bath)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho_bath, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, Filling, ImpHam, basis, solver, solver_args,
            thrnelec=1e-5, delta=0.01, step=0.1)
        last_dmu += dmu
        _, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        rho_glob_R = embham.get_rho_glob_R(basis, Lat, rhoEmb)
        if idem:
            nel = Lat.ncells * nsc * Filling
            rho_glob_R = embham.get_rdm1_idem(
                rho_glob_R, [nel, nel], tuple(int(x) for x in Lat.kmesh),
                **kw)
        rho_glob = np.asarray(rho_glob_R)
        if it >= 2:
            rho_glob = adiis.update(rho_glob.ravel()).reshape(rho_glob.shape)
        rec.append((float(EnergyImp), float(nelecImp), last_dmu,
                    rho_glob.copy()))
    return rec


@pytest.mark.parametrize("idem", [False, True])
def test_pdmet_three_iterations_match_jax(idem):
    rec_j = _pdmet(False, idem)
    rec_t = _pdmet(True, idem)
    for (Ej, nj, dj, rj), (Et, nt, dt, rt) in zip(rec_j, rec_t):
        assert abs(Et - Ej) < 1e-7
        assert abs(nt - nj) < 1e-7
        assert abs(dt - dj) < 1e-7
        assert np.abs(rt - rj).max() < 1e-7
    # the loop moves: the energy changes between iterations, and the
    # global density stays at half filling
    assert abs(rec_t[0][0] - rec_t[2][0]) > 1e-4
    nsc = 4
    assert abs(np.trace(rec_t[2][3][:, 0], axis1=1, axis2=2).sum()
               - nsc) < 1e-6


def _ib_fock(port, vcor_starts=None, niter=2):
    """The loop of test_hub2d_ib_fock.  vcor_starts: per-iteration vcor
    parameters to start from (the other package's); records the start
    parameters it used."""
    dmet, embham, mfd, DIIS, FCI, kw = _mods(port)
    U, beta = 8.0, 1000.0
    Filling = 0.5
    Mu, last_dmu = U * Filling, 0.0
    Lat = dmet.SquareLattice(6, 6, 2, 2)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=False, **kw)
    nsc = Lat.nscsites
    vcor = dmet.VcorLocal(False, False, nsc)
    vcor.update(np.zeros(vcor.length()))
    rho_seed = np.zeros((2, Lat.ncells, nsc, nsc))
    rho_seed[0, 0] = np.diag([1.0, 0.0, 0.0, 1.0])
    rho_seed[1, 0] = np.diag([0.0, 1.0, 1.0, 0.0])
    Lat.update_Ham(rho_seed)
    rho, Mu, E, res = mfd.HF_scf(Lat, vcor, Filling, False, beta=beta,
                                 ires=True)
    Lat.update_Ham(rho)
    solver = FCI(restricted=False, tol=1e-10, **kw)
    mu_solver = dmet.MuSolver(adaptive=True)
    rec = []
    for it in range(niter):
        if vcor_starts is not None:
            vcor.update(vcor_starts[it])
        start = vcor.param.copy()
        rho, Mu, res = dmet.HartreeFock(Lat, vcor, Filling, Mu, beta=beta,
                                        ires=True)
        Lat.update_Ham(rho)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, Filling, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        rhoImp, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, beta, Filling,
                                     MaxIter1=0, MaxIter2=300, imp_fit=True,
                                     BFGS=True)
        vcor.update(np.hstack(vcor_new.param))
        rec.append(dict(start=start, E=float(EnergyImp),
                        nelec=float(nelecImp), dmu=last_dmu, err=float(err),
                        rhoImp=np.asarray(rhoImp), param=vcor.param.copy()))
    return rec


def test_hub2d_ib_fock_two_iterations_match_jax():
    """E, nelec, dmu, the impurity density and the whole-lattice fit's
    final error at 1e-6; the fitted parameters at 1e-4 (the impurity-block
    residual leaves the uniform shift flat, and BFGS stops along it at
    slightly different points)."""
    rec_j = _ib_fock(False)
    rec_t = _ib_fock(True, vcor_starts=[r["start"] for r in rec_j])
    for rj, rt in zip(rec_j, rec_t):
        assert np.array_equal(rt["start"], rj["start"])
        for key in ("E", "nelec", "dmu", "err"):
            assert abs(rt[key] - rj[key]) < 1e-6, key
        assert np.abs(rt["rhoImp"] - rj["rhoImp"]).max() < 1e-6
        assert np.abs(rt["param"] - rj["param"]).max() < 1e-4
    assert rec_t[1]["err"] < 1e-3
    assert np.abs(rec_t[0]["param"]).max() > 1e-2
