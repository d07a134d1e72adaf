"""
One-call self-consistent DMET loop (PyTorch port of run_dmet of
libdmet_preview_tpu/dmet/loop.py; configured by utils.config.DmetConfig).

run_dmet(lattice, vcor, config) executes:
  mean field -> (optional charge self-consistency) -> impurity Ham ->
  chemical-potential-fitted solver -> energy/density back-transform ->
  vcor fit (+ trace fix) -> DIIS, until vcor and energy converge.

Everything runs on the lattice's device (the one given to set_Ham, the
card by default).  Each step is a utils.timer stage.  Returns a DmetResult
with the converged energy per site, impurity density, vcor, mu, and the
iteration history.  The superconducting loop (run_dmet_sc) is still to
port.
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
