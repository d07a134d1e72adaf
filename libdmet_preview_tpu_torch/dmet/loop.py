"""
One-call self-consistent DMET loop (PyTorch port of run_dmet of
libdmet_preview_tpu/dmet/loop.py; configured by utils.config.DmetConfig).

run_dmet(lattice, vcor, config) executes:
  mean field -> (optional charge self-consistency) -> impurity Ham ->
  chemical-potential-fitted solver -> energy/density back-transform ->
  vcor fit (+ trace fix) -> DIIS, until vcor and energy converge.

run_dmet_sc(lattice, vcor, filling) is the superconducting loop in the
particle-hole transformed (GSO) frame: HFB mean field with a physical-mu
fit, spinless bath and embedding, FCI(ghf=True) under a secant dmu fit,
Bogoliubov vcor fit, damping and DIIS.

Everything runs on the lattice's device (the one given to set_Ham, the
card by default).  Each step is a utils.timer stage.  Returns a DmetResult
with the converged energy per site, impurity density, vcor, mu, and the
iteration history.
"""

from dataclasses import dataclass, field

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.config import DmetConfig
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.ops.diis import DIIS
import libdmet_preview_tpu_torch.dmet.hubbard as facade


@dataclass
class DmetResult:
    converged: bool
    e_per_site: float
    nelec_imp: float
    mu: float
    last_dmu: float
    vcor: object
    rho_imp: np.ndarray
    history: list = field(default_factory=list)


def _make_solver(config, device):
    from libdmet_preview_tpu_torch import solvers
    name = config.solver.upper()
    kw = dict(restricted=config.restricted, tol=config.solver_tol,
              device=device)
    if name == "FCI":
        return solvers.FCI(**kw)
    if name == "CCSD":
        return solvers.CCSD(**kw)
    if name == "MP2":
        return solvers.MP2(**kw)
    if name == "HF":
        return solvers.SCFSolver(restricted=config.restricted, device=device)
    if name == "CASCI":
        raise ValueError("CASCI needs an explicit (ncas, nelecas); pass a "
                         "solver instance via run_dmet(..., solver=...)")
    raise ValueError("unknown solver %s" % config.solver)


def run_dmet(lattice, vcor, config=None, solver=None, mu0=None):
    """Self-consistent DMET on a prepared lattice (set_Ham done) with the
    given starting vcor, on the lattice's device.  config: DmetConfig
    (validated); solver: optional solver instance overriding
    config.solver."""
    config = (config or DmetConfig()).validate()
    device = lattice.device
    if solver is None:
        solver = _make_solver(config, device)
    mu_solver = facade.MuSolver(adaptive=True)
    adiis = DIIS(space=config.diis_dim)
    if config.use_hcore_as_emb_ham is not None:
        lattice.use_hcore_as_emb_ham = config.use_hcore_as_emb_ham
    charge_sc = config.charge_sc
    if charge_sc is None:   # workflow default
        charge_sc = config.int_bath and lattice.H2_format == "local"

    mu = mu0
    last_dmu = 0.0
    E_old = 0.0
    history = []
    conv = False
    rhoImp = EnergyImp = nelecImp = None
    for it in range(config.max_iter):
        with stage("mean field", device):
            rho, mu, res = facade.HartreeFock(lattice, vcor, config.filling,
                                              mu, beta=config.beta, ires=True)
            if charge_sc:
                lattice.update_Ham(np.asarray(rho)
                                   * (2.0 if config.restricted else 1.0))
        ImpHam, H1e, basis = facade.ConstructImpHam(
            lattice, rho, vcor, matching=False, int_bath=config.int_bath,
            valence_bath=config.valence_bath, tol_bath=config.tol_bath)
        ImpHam = facade.apply_dmu(lattice, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (lattice.ncore + lattice.nval) * 2}
        with stage("impurity solves", device):
            rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
                lattice, config.filling, ImpHam, basis, solver, solver_args,
                thrnelec=config.mu_thrnelec, step=config.mu_step)
        last_dmu += dmu
        with stage("energy", device):
            rhoImp, EnergyImp, nelecImp = facade.transformResults(
                rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=lattice,
                last_dmu=last_dmu, int_bath=config.int_bath, solver=solver,
                solver_args=solver_args)

        with stage("vcor fit", device):
            vcor_new, err = facade.FitVcor(rhoEmb, lattice, basis, vcor,
                                           config.beta, config.filling,
                                           MaxIter1=config.fit_max_iter,
                                           MaxIter2=0,
                                           method=config.fit_method,
                                           imp_fit=config.fit_imp_only)
        if it >= config.trace_start and not vcor.restricted:
            ddiagV = np.average(np.diagonal(
                (vcor_new.get() - vcor.get())[:2], 0, 1, 2))
            vcor_new = facade.addDiag(vcor_new, -ddiagV)
        if it >= config.diis_start:
            pvcor = adiis.update(np.hstack(vcor_new.param))
        else:
            pvcor = np.hstack(vcor_new.param)
        dVcor = float(np.linalg.norm(pvcor - vcor.param)
                      / max(len(vcor.param), 1))
        vcor.update(pvcor)
        dE = float(EnergyImp - E_old)
        E_old = float(EnergyImp)
        history.append({"iter": it, "E": float(EnergyImp),
                        "nelec": float(nelecImp), "dE": dE,
                        "dVcor": dVcor, "fit_err": float(err),
                        "last_dmu": float(last_dmu),
                        "vcor_param": np.array(vcor_new.param, copy=True),
                        "rho_imp": rhoImp.cpu().numpy()})
        log.result("DMET iter %2d  E = %14.8f  dE = %8.2e  dVcor = %8.2e",
                   it, EnergyImp, dE, dVcor)
        if config.chkfile:
            from libdmet_preview_tpu_torch.utils.chkfile import save_dmet_iter
            save_dmet_iter(config.chkfile, mu if mu is not None else 0.0,
                           last_dmu, vcor.param, rho_emb=rhoEmb,
                           basis=basis, rho_imp=rhoImp,
                           extra={"iter": it, "E": float(EnergyImp)})
        if dVcor < config.conv_tol_vcor and abs(dE) < config.conv_tol_E \
                and it > 3:
            conv = True
            break
    return DmetResult(conv, float(EnergyImp), float(nelecImp),
                      float(mu if mu is not None else 0.0), last_dmu,
                      vcor, rhoImp.cpu().numpy(), history)


def run_dmet_sc(lattice, vcor, filling, solver=None, max_iter=20,
                mu0=0.0, diis_start=3, diis_dim=4, conv_tol_E=1e-6,
                conv_tol_vcor=1e-5, thrnelec=1e-7, fit_max_iter=200,
                mixing=1.0, beta=np.inf, localize_bath=None,
                trace_start=None, dmu0=0.0):
    """One-call SUPERCONDUCTING (GSO-frame) DMET on the lattice's device:
    HFB mean field with a physical-mu fit, spinless bath + embedding,
    FCI(ghf=True) with a secant dmu fit (warm-started from the previous
    iteration's dmu), Bogoliubov vcor fit, the mu-absorbable trace fix
    from iteration trace_start on, damped update (mixing) and DIIS from
    diis_start on.

    vcor: a Bogoliubov vcor (e.g. hubbard_bcs.VcorSC) with [va, vb, D]
    components; dmu0 starts the accumulated impurity dmu.  Returns a
    DmetResult (rho_imp = GRho_imp, the anomalous block included); each
    history record also holds the iteration's start ("vcor_start",
    "mu_start", "dmu_start": what a run that begins with this iteration
    takes as vcor, mu0 and dmu0), "mu", "dmu", the impurity GSO density
    ("rho_imp") and the vcor parameters the iteration ended with
    ("vcor_param")."""
    from libdmet_preview_tpu_torch.dmet import hubbard_bcs as bcs
    from libdmet_preview_tpu_torch.ops import spinless
    from libdmet_preview_tpu_torch.ops.fit import keep_vcor_trace_fixed
    from libdmet_preview_tpu_torch.solvers import FCI

    device = lattice.device
    if solver is None:
        solver = FCI(restricted=True, ghf=True, tol=1e-10, device=device)
    gham = bcs.GSOHam(lattice)
    adiis = DIIS(space=diis_dim)
    mu = mu0
    last_dmu = dmu0
    E_old = 0.0
    history = []
    conv = False
    GRhoImp = Efrag = n = None
    for it in range(max_iter):
        start = {"vcor_start": np.array(vcor.param, copy=True),
                 "mu_start": float(mu), "dmu_start": float(last_dmu)}
        vmat = spinless.combine_vcor(np.asarray(vcor.get()))
        with stage("mean field", device):
            GRho, mu, res = bcs.GHartreeFock(gham, filling, mu0=mu,
                                             vcor_mat=vmat, beta=beta)
        ImpHam, _, basis = bcs.ConstructImpHam(gham, GRho, mu,
                                               vcor_mat=vmat,
                                               localize_bath=localize_bath)
        with stage("impurity solves", device):
            rdm, E_emb, ImpHam_d, dmu = bcs.SolveImpHam_with_fitting(
                gham, filling, ImpHam, basis, solver, dmu0=last_dmu,
                thrnelec=thrnelec)
        last_dmu = dmu
        with stage("energy", device):
            GRhoImp, Efrag, n = bcs.transformResults(rdm, E_emb, basis,
                                                     ImpHam_d, gham, mu,
                                                     last_dmu=dmu)
        with stage("vcor fit", device):
            vcor_new, err = bcs.FitVcor(rdm, lattice, basis, vcor, gham, mu,
                                        MaxIter=fit_max_iter)
        if trace_start is not None and it >= trace_start:
            # remove the mu-absorbable diagonal drift so that vcor and mu
            # do not spiral together
            vcor_new = keep_vcor_trace_fixed(vcor_new, vcor)
        # damped update (mixing < 1 steadies oscillatory Bogoliubov fits,
        # e.g. d-wave at repulsive U); DIIS on the damped sequence
        p_next = (1.0 - mixing) * np.asarray(vcor.param) \
            + mixing * np.asarray(vcor_new.param)
        if it >= diis_start:
            pvcor = adiis.update(p_next)
        else:
            pvcor = p_next
        dVcor = float(np.linalg.norm(pvcor - vcor.param)
                      / max(len(vcor.param), 1))
        vcor.update(pvcor)
        dE = float(Efrag - E_old)
        E_old = float(Efrag)
        history.append({"iter": it, "E": float(Efrag), "nelec": float(n),
                        "dE": dE, "dVcor": dVcor, "fit_err": float(err),
                        "mu": float(mu), "dmu": float(dmu),
                        "rho_imp": GRhoImp.cpu().numpy(),
                        "vcor_param": np.array(pvcor, copy=True), **start})
        log.result("SC-DMET iter %2d  E = %14.8f  dE = %8.2e  "
                   "dVcor = %8.2e", it, Efrag, dE, dVcor)
        if dVcor < conv_tol_vcor and abs(dE) < conv_tol_E and it > 3:
            conv = True
            break
    return DmetResult(conv, float(Efrag), float(n), float(mu), last_dmu,
                      vcor, GRhoImp.cpu().numpy(), history)
