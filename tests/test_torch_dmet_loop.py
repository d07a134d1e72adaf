"""
The slice as a whole: the self-consistent DMET loop on model lattices in
the PyTorch port (libdmet_preview_tpu_torch/dmet/hubbard.py, dmet/loop.py)
against the JAX package's, on the CPU.

  * the hand-written loop of tests/test_dmet_hub1d.py::run_hub1d
    (mean field -> update_Ham -> ConstructImpHam -> apply_dmu -> MuSolver
    around FCI -> transformResults -> FitVcor -> trace fix), three
    iterations in both packages with both baths, and two iterations on
    SquareLattice(8, 8, 2, 2) spin-unrestricted;
  * run_dmet in the port alone to convergence on the published anchors:
    1D Hubbard 18 sites U=4 (-0.552733945102 NIB, -0.572957334871 IB) and
    2D Hubbard 40x40 U=6 NIB / U=2 IB, 2x2 impurity (-0.652114179764,
    -1.179836342898);
  * run_dmet over Cholesky ERIs (interacting bath, restricted, FCI) on a
    seeded random gapped chain, two iterations in both packages on the
    same arrays.

Energies, electron counts and dmu do not depend on the gauge each
package's eigensolver picks for the bath.  The fitted vcor does, a little:
the CG of FitVcorEmb stops once the error falls by less than ytol = 1e-7
per step, and where the error is flat along a valley (the restricted
interacting-bath chain) a change of 1e-11 in the target moves the stopping
point by 5e-4 in the parameters, in either package (on identical inputs
the two agree to 1e-8, tests/test_torch_fitvcor.py).  So the port's loop
starts every iteration from the vcor the JAX loop started it from, and
what each iteration produces is compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")
FILLING = 0.5


def hand_loop(dmet, solver, Lat, vcor, U, int_bath, n_iter, starts=None):
    """run_hub1d's loop body for n_iter iterations; returns per-iteration
    (E, nelec, last_dmu, fitted vcor.param, fit error, vcor.param at the
    iteration's start) records.  With `starts`, iteration i starts from
    the parameters starts[i]."""
    restricted = vcor.restricted
    Mu = U * FILLING
    last_dmu = 0.0
    mu_solver = dmet.MuSolver(adaptive=True)
    records = []
    for it in range(n_iter):
        if starts is not None:
            vcor.update(starts[it])
        start = vcor.param.copy()
        rho, Mu, res = dmet.HartreeFock(Lat, vcor, FILLING, Mu, ires=True)
        if int_bath:
            Lat.update_Ham(rho * (2.0 if restricted else 1.0))
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=int_bath)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, FILLING, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        rhoImp, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=int_bath, solver=solver,
            solver_args=solver_args)
        vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf,
                                     FILLING, MaxIter2=0)
        if it >= 3:
            ddiagV = np.average(np.diagonal(
                (vcor_new.get() - vcor.get())[:2], 0, 1, 2))
            vcor_new = dmet.addDiag(vcor_new, -ddiagV)
        vcor.update(np.hstack(vcor_new.param))
        records.append((float(EnergyImp), float(nelecImp), float(last_dmu),
                        vcor.param.copy(), float(err), start))
    return records


def both_hand_loops(kind, U, int_bath, n_iter):
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.solvers import FCI as JFCI
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    out = []
    starts = None
    for dmet, kw in ((jdmet, {}), (tdmet, {"device": CPU})):
        if kind == "chain":
            Lat = dmet.ChainLattice(18, 2)
            vcor = dmet.PMInitGuess([2], U, FILLING)
        else:
            Lat = dmet.SquareLattice(8, 8, 2, 2)
            vcor = dmet.AFInitGuess((2, 2), U, FILLING)
        Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, **kw)
        FCI = JFCI if dmet is jdmet else tdmet.FCI
        solver = FCI(restricted=vcor.restricted, tol=1e-11, **kw)
        out.append(hand_loop(dmet, solver, Lat, vcor, U, int_bath, n_iter,
                             starts))
        starts = [r[5] for r in out[0]]
    return out


def _compare_records(rec_j, rec_t, tol_param):
    for (E_j, n_j, dmu_j, p_j, err_j, _), (E_t, n_t, dmu_t, p_t, err_t, _) \
            in zip(rec_j, rec_t):
        assert abs(E_t - E_j) < 1e-7
        assert abs(n_t - n_j) < 1e-7
        assert abs(dmu_t - dmu_j) < 1e-6
        assert abs(err_t - err_j) < 1e-6
        assert np.abs(p_t - p_j).max() < tol_param


@pytest.mark.parametrize("int_bath", [False, True])
def test_hub1d_three_iterations_match_jax(int_bath):
    """Per iteration: E 1e-7, nelec 1e-7, accumulated dmu 1e-6, fit
    error 1e-6; fitted vcor.param 1e-5 with the non-interacting bath and
    1e-3 with the interacting one (the flat valley, see above)."""
    rec_j, rec_t = both_hand_loops("chain", 4.0, int_bath, 3)
    _compare_records(rec_j, rec_t, 1e-3 if int_bath else 1e-5)
    assert abs(rec_t[0][0] - rec_t[2][0]) > 1e-6    # the loop moves


@pytest.mark.parametrize("int_bath,U", [(False, 6.0), (True, 2.0)])
def test_hub2d_8x8_two_iterations_match_jax(int_bath, U):
    """Spin-unrestricted (AF guess) UHF + FCI on the 8x8 square, 2x2
    impurity: E 1e-7, nelec 1e-7, dmu 1e-6, fit error 1e-6, fitted
    vcor.param 1e-5."""
    rec_j, rec_t = both_hand_loops("square", U, int_bath, 2)
    _compare_records(rec_j, rec_t, 1e-5)


@pytest.mark.parametrize("int_bath,anchor", [(False, -0.552733945102),
                                             (True, -0.572957334871)])
def test_run_dmet_hub1d_anchor(int_bath, anchor):
    """run_dmet to convergence on the 1D anchors, 1e-4."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet
    from libdmet_preview_tpu_torch.utils.config import DmetConfig
    Lat = dmet.ChainLattice(18, 2)
    Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True, device=CPU)
    vcor = dmet.PMInitGuess([2], 4.0, FILLING)
    cfg = DmetConfig(filling=FILLING, restricted=False, int_bath=int_bath,
                     solver="FCI", max_iter=20)
    res = run_dmet(Lat, vcor, cfg)
    assert res.converged
    assert abs(res.e_per_site - anchor) < 1e-4
    assert abs(res.nelec_imp - 1.0) < 1e-4
    assert len(res.history) >= 4
    assert res.rho_imp.shape == (1, 2, 2)


@pytest.mark.parametrize("int_bath,U,anchor", [(False, 6.0, -0.652114179764),
                                               (True, 2.0, -1.179836342898)])
def test_run_dmet_hub2d_40x40_anchor(int_bath, U, anchor, tmp_path):
    """run_dmet to convergence on the 2D anchors (40x40, 2x2 impurity,
    AF guess, UHF + FCI, charge self-consistency on for the interacting
    bath by the config's default), 1e-4; the checkpoint of the last
    iteration restores the loop's vcor."""
    import libdmet_preview_tpu_torch.dmet.hubbard as dmet
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet
    from libdmet_preview_tpu_torch.utils import chkfile
    from libdmet_preview_tpu_torch.utils.config import DmetConfig
    Lat = dmet.SquareLattice(40, 40, 2, 2)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=CPU)
    vcor = dmet.AFInitGuess((2, 2), U, FILLING)
    cfg = DmetConfig(filling=FILLING, restricted=False, int_bath=int_bath,
                     solver="FCI", solver_tol=1e-10, max_iter=20,
                     chkfile=str(tmp_path / "dmet_iter.npz"))
    res = run_dmet(Lat, vcor, cfg)
    assert res.converged
    assert abs(res.e_per_site - anchor) < 1e-4
    assert abs(res.nelec_imp - 1.0) < 1e-4
    assert res.rho_imp.shape == (2, 4, 4)
    v2 = dmet.AFInitGuess((2, 2), U, FILLING)
    mu, last_dmu = chkfile.restart_from_dmet_iter(v2, cfg.chkfile)
    assert np.array_equal(v2.param, res.vcor.param)
    assert last_dmu == res.last_dmu


def test_run_dmet_unported_solvers_raise():
    """Every solver DmetConfig names is built but CASCI, which needs an
    explicit active space; an unknown name raises."""
    from libdmet_preview_tpu_torch import solvers
    from libdmet_preview_tpu_torch.dmet.loop import _make_solver
    from libdmet_preview_tpu_torch.utils.config import DmetConfig
    for name, cls in (("FCI", solvers.FCI), ("CCSD", solvers.CCSD),
                      ("MP2", solvers.MP2), ("HF", solvers.SCFSolver)):
        s = _make_solver(DmetConfig(solver=name, restricted=True), CPU)
        assert type(s) is cls and s.restricted and s.device == CPU
    for name in ("CASCI", "DMRG"):
        with pytest.raises(ValueError):
            _make_solver(dataclasses.replace(DmetConfig(), solver=name), CPU)


# ----------------------------------------------------------------------
# the loop over Cholesky ERIs
# ----------------------------------------------------------------------

def chol_chain_workload(seed=5, ncells=4, nlo=2, naux=24):
    """A random gapped chain with Cholesky ERIs, NumPy from `seed`:
    spinless hcore/fock stripes (ncells, nlo, nlo) with half of each
    cell's orbitals at -1 and half at +1, chol_L (naux, nsites, nsites)
    symmetric in (p, q), and the unit-cell ERI."""
    rng = np.random.RandomState(seed)

    def stripe(scale):
        h = np.zeros((ncells, nlo, nlo))
        for R in range(ncells // 2 + 1):
            blk = rng.randn(nlo, nlo) * scale / (1.0 + min(R, ncells - R)) ** 2
            if R == 0 or 2 * R == ncells:
                blk = 0.5 * (blk + blk.T)
            h[R] = blk
            h[(-R) % ncells] = blk.T
        return h

    hcore = stripe(0.1)
    hcore[0] += np.diag([-1.0 if i < nlo // 2 else 1.0 for i in range(nlo)])
    fock = hcore + stripe(0.05)
    nsites = ncells * nlo
    L = rng.randn(naux, nsites, nsites)
    L = 0.05 * (L + L.transpose(0, 2, 1))
    L0 = L[:, :nlo, :nlo].reshape(naux, nlo * nlo)
    eri_imp = (L0.T @ L0).reshape((nlo,) * 4)
    return hcore, fock, L, eri_imp


def test_run_dmet_cholesky_two_iterations_match_jax():
    """run_dmet(int_bath=True, restricted=True, FCI) on the Cholesky
    chain in both packages (the JAX package takes its CPU eri_from_df
    path, the port its syrk's plain version): per iteration E and nelec
    1e-7, the final vcor.param 1e-5."""
    from libdmet_preview_tpu.models.abinitio import AbInitioHam
    from libdmet_preview_tpu.models.lattice import ChainLattice
    from libdmet_preview_tpu.ops import mfd as jmfd
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.dmet.loop import run_dmet as jrun
    from libdmet_preview_tpu.utils.config import DmetConfig as JConfig
    from libdmet_preview_tpu_torch import interop
    from libdmet_preview_tpu_torch.dmet.loop import run_dmet as trun
    ncells, nlo = 4, 2
    hcore, fock, L, eri_imp = chol_chain_workload(ncells=ncells, nlo=nlo)
    Lat = ChainLattice(ncells * nlo, nlo)
    Ham = AbInitioHam(hcore, fock, L, eri_imp, 0.0)
    Lat.set_Ham_abinitio(Ham)
    # the stored (spin-traced) mean-field density of the lattice Fock
    rho, _, _ = jmfd.HF(Lat, None, FILLING, True)
    rdm1 = np.asarray(rho) * 2.0
    Lat.set_Ham_abinitio(Ham, rdm1=rdm1)
    vcor = VcorLocal(True, False, nlo)
    cfg = JConfig(filling=FILLING, restricted=True, int_bath=True,
                  solver="FCI", max_iter=2)
    res_j = jrun(Lat, vcor, cfg)

    lat_t = interop.abinitio_lattice_from_numpy(
        (ncells,), nlo, hcore, fock, L, eri_imp, 0.0, rdm1_R=rdm1, device=CPU)
    vcor_t = interop.vcor_local_from_numpy(True, nlo, np.zeros(vcor.length()))
    cfg_t = interop.dmet_config_from_dict(dataclasses.asdict(cfg))
    res_t = trun(lat_t, vcor_t, cfg_t)
    assert len(res_t.history) == len(res_j.history) == 2
    for h_j, h_t in zip(res_j.history, res_t.history):
        assert abs(h_t["E"] - h_j["E"]) < 1e-7
        assert abs(h_t["nelec"] - h_j["nelec"]) < 1e-7
        assert abs(h_t["fit_err"] - h_j["fit_err"]) < 1e-7
    assert abs(res_t.last_dmu - res_j.last_dmu) < 1e-6
    assert np.abs(res_t.vcor.param - res_j.vcor.param).max() < 1e-5
    assert np.abs(res_t.vcor.param).max() > 1e-4      # the fit moved vcor
