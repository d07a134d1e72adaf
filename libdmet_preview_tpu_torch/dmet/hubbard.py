"""
DMET user-facing API for Hubbard-family lattice models (PyTorch port of
libdmet_preview_tpu/dmet/hubbard.py).

Carries the JAX package's vocabulary so that user loops translate one to
one: HartreeFock / RHartreeFock, ConstructImpHam, apply_dmu,
SolveImpHam_with_fitting (MuSolver), transformResults, FitVcor,
AFInitGuess / PMInitGuess, addDiag, IterHistory, foldRho_k.  dmet/loop.py
packages the self-consistent loop over them (run_dmet).

The one-shot driver, as in tests/test_cuo2_afm.py:

    rho, mu, res = HartreeFock(Lat, vcor, filling, None, ires=True)
    ImpHam, H1e, basis = ConstructImpHam(Lat, rho, vcor, matching=True,
                                         int_bath=True)
    rdm1, E = SCFSolver(restricted=False, device=...).run(ImpHam, nelec,
                                                          dm0=...)
    _, E_cell, nelec_cell = transformResults(rdm1, E, basis, ImpHam, H1e,
                                             lattice=Lat, last_dmu=0.0,
                                             int_bath=True, solver=...)

Embedding quantities are tensors on the lattice's device.
"""

import os
import pickle
from math import copysign, exp

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage, to_host
from libdmet_preview_tpu_torch.models.lattice import (  # noqa: F401
    ChainLattice, SquareLattice, SquareAFM, Square3Band, Square3BandAFM,
    Square3BandSymm, CubicLattice, HoneycombLattice, BipartiteSquare)
from libdmet_preview_tpu_torch.models.hamiltonian import (  # noqa: F401
    HubbardHamiltonian as Ham, HubbardExtended, Hubbard3band,
    Hubbard3band_ref, HubbardDCA)
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.ops import embham, mfd, fit as fit_mod
from libdmet_preview_tpu_torch.ops.vcor import (  # noqa: F401
    VcorLocal, VcorLocalPhSymm, VcorDCAPhSymm, VcorSymm, VcorSymmBogo,
    VcorNonLocal, VcorKpoints, VcorRestricted)
from libdmet_preview_tpu_torch.ops.diis import DIIS, FDiisContext  # noqa: F401
from libdmet_preview_tpu_torch.ops.fit import (  # noqa: F401
    addDiag, make_vcor_trace_unchanged, vcor_diag_average)
from libdmet_preview_tpu_torch.dmet.quad_fit import quad_fit_mu
from libdmet_preview_tpu_torch.solvers import FCI, SCFSolver  # noqa: F401

foldRho_k = embham.foldRho_k
HF = mfd.HF


# ----------------------------------------------------------------------
# mean field wrappers
# ----------------------------------------------------------------------

def HartreeFock(Lat, v, filling, mu0=None, beta=np.inf, ires=False, **kwargs):
    rho, mu, E, res = mfd.HF(Lat, v, filling, v.restricted, mu0=mu0,
                             beta=beta, ires=True, **kwargs)
    log.result("Chemical potential (mean-field) = %s", mu)
    log.result("Energy per cell (mean-field) = %20.12f", E)
    log.result("Gap (mean-field) = %s", res["gap"])
    if ires:
        return rho, mu, res
    return rho, mu


def RHartreeFock(Lat, v, filling, mu0=None, beta=np.inf, ires=False, **kwargs):
    log.eassert(v.restricted, "RHF requires restricted vcor")
    return HartreeFock(Lat, v, filling, mu0=mu0, beta=beta, ires=ires, **kwargs)


# ----------------------------------------------------------------------
# impurity Hamiltonian
# ----------------------------------------------------------------------

def ConstructImpHam(Lat, rho, v, mu=None, matching=True, local=True,
                    int_bath=False, **kwargs):
    with stage("bath", Lat.device):
        log.result("Making embedding basis")
        basis = embham.embBasis(Lat, rho, local=local, **kwargs)
        if matching and basis.shape[0] == 2:
            log.result("Rotating bath to match alpha/beta")
            nimp = Lat.nimp
            basis[:, :, :, nimp:] = _match_bath(basis[:, :, :, nimp:])
    log.result("Constructing impurity Hamiltonian")
    ImpHam, H1e = embham.embHam(Lat, basis, v, local=local, int_bath=int_bath,
                                **kwargs)
    return ImpHam, H1e, basis


def _match_bath(basis_bath):
    """Rotate the beta bath to match the alpha bath.  An empty bath (a
    one-cell lattice: the impurity is the whole supercell) has nothing to
    match; the JAX package's reshape raises there."""
    shape = basis_bath.shape
    if shape[-1] == 0:
        return basis_bath
    flat = basis_bath.reshape(2, -1, shape[-1])
    return embham.basis_matching(flat).reshape(shape)


def apply_dmu(lattice, ImpHam, basis, dmu, **kwargs):
    """Add -dmu on the impurity orbitals of H1_emb, in place on the
    tensors of ImpHam.H1["cd"]."""
    dmu_idx = kwargs.get("dmu_idx", None)
    if dmu_idx is None:
        dmu_idx = lattice.imp_idx
    nao = lattice.nao
    mu_mat = np.zeros((nao, nao))
    mu_mat[dmu_idx, dmu_idx] = -dmu
    mu_mat = as_f64(mu_mat, basis.device)
    H1 = ImpHam.H1["cd"]
    for s in range(1 if ImpHam.restricted else 2):
        H1[s] += embham.transform_imp(basis[s], mu_mat)
    return ImpHam


def SolveImpHam_with_dmu(lattice, ImpHam, basis, dmu, solver, solver_args={},
                         **kwargs):
    ImpHam = apply_dmu(lattice, ImpHam, basis, dmu, **kwargs)
    result = solver.run(ImpHam, **solver_args)
    ImpHam = apply_dmu(lattice, ImpHam, basis, -dmu, **kwargs)
    return result


# ----------------------------------------------------------------------
# results transform + energy
# ----------------------------------------------------------------------

def _env_idx(nbasis, imp_idx):
    return np.asarray([i for i in range(nbasis) if i not in imp_idx],
                      dtype=int)


def get_H1_scaled(H1, imp_idx, env_idx=None):
    """Democratic partitioning of H1 (spin, n, n) tensor: imp-env blocks
    halved, env-env zeroed."""
    H1 = H1.clone()
    if env_idx is None:
        env_idx = _env_idx(H1.shape[-1], imp_idx)
    imp = torch.as_tensor(np.asarray(imp_idx, dtype=int), device=H1.device)
    env = torch.as_tensor(np.asarray(env_idx, dtype=int), device=H1.device)
    H1[:, imp[:, None], env[None, :]] *= 0.5
    H1[:, env[:, None], imp[None, :]] *= 0.5
    H1[:, env[:, None], env[None, :]] = 0.0
    return H1


def get_H2_scaled(H2, imp_idx, env_idx=None):
    """Democratic partitioning of a (spin_pair, n, n, n, n) H2 tensor: each
    index contributes 1/4 weight when on the impurity."""
    nbasis = H2.shape[-1]
    w = torch.zeros(nbasis, dtype=H2.dtype, device=H2.device)
    w[torch.as_tensor(np.asarray(imp_idx, dtype=int), device=H2.device)] = 1.0
    factor = 0.25 * (w[:, None, None, None] + w[None, :, None, None]
                     + w[None, None, :, None] + w[None, None, None, :])
    return H2 * factor


def transformResults(rhoEmb, E, basis, ImpHam, H1e=None, int_bath=False,
                     **kwargs):
    """rhoEmb (spin, neo, neo) tensor -> (rhoImp, E_per_cell,
    nelec_per_cell)."""
    spin = rhoEmb.shape[0]
    nscsites = basis.shape[2]
    nbasis = basis.shape[-1]

    if "lattice" in kwargs and kwargs["lattice"] is not None:
        imp_idx = np.asarray(kwargs.get("imp_idx",
                                        range(kwargs["lattice"].nimp)))
    else:
        imp_idx = np.asarray(kwargs.get("imp_idx", np.arange(nscsites)))
    imp_t = torch.as_tensor(imp_idx, device=rhoEmb.device)
    nelec = to_host(sum(torch.sum(rhoEmb[s, imp_t, imp_t])
                        for s in range(spin)), float) * 2.0 / spin
    rhoImp = rhoEmb[:, imp_t[:, None], imp_t[None, :]]

    if E is None:
        return nelec / nscsites

    lattice = kwargs["lattice"]
    last_dmu = kwargs["last_dmu"]
    dmu_idx = kwargs.get("dmu_idx", None)
    if dmu_idx is None:
        dmu_idx = list(range(nscsites))
    env_idx = _env_idx(nbasis, imp_idx)
    H1 = ImpHam.H1["cd"]

    E2 = E - to_host(torch.einsum("spq, sqp", H1, rhoEmb), float) \
        * (2.0 / spin) - ImpHam.H0

    H1_scaled = H1.clone()
    dmu_mat = torch.zeros((nscsites, nscsites), dtype=H1.dtype,
                          device=H1.device)
    dmu_t = torch.as_tensor(np.asarray(dmu_idx, dtype=int), device=H1.device)
    dmu_mat[dmu_t, dmu_t] = -last_dmu
    for s in range(spin):
        H1_scaled[s] -= embham.transform_imp(basis[s], dmu_mat)
        if lattice.JK_core is not None:
            H1_scaled[s] -= 0.5 * lattice.JK_core[s]
    H1_scaled = get_H1_scaled(H1_scaled, imp_idx, env_idx)

    E1 = to_host(torch.einsum("spq, sqp", H1_scaled, rhoEmb), float) \
        * (2.0 / spin)
    Efrag = E1 + E2 + lattice.getH0()

    if int_bath:
        solver = kwargs.get("solver", None)
        solver_args = kwargs.get("solver_args", {})
        kwargs.setdefault("rdm1_emb", rhoEmb)
        Efrag = get_E_dmet(basis, lattice, ImpHam, last_dmu, solver,
                           solver_args=solver_args, imp_idx=list(imp_idx),
                           **{k: v for k, v in kwargs.items()
                              if k in ("add_vcor_to_E", "vcor", "E1",
                                       "rdm1_emb", "veff")})
    log.debug(0, "E0 = %20.12f, E1 = %20.12f, E2 = %20.12f, E = %20.12f",
              lattice.getH0(), E1, E2, Efrag)
    return rhoImp, Efrag / nscsites, nelec / nscsites


def get_H_dmet(basis, lattice, ImpHam, last_dmu, imp_idx=None,
               add_vcor_to_E=False, vcor=None, E1=None, rdm1_emb=None,
               veff=None, **kwargs):
    """Scaled (democratic-partitioning) DMET Hamiltonian for the
    interacting-bath energy functional.

    E1: optional externally evaluated one-body energy (hcore + J/K from
    the GLOBAL density matrix, embham.get_E1_from_glob): the scaled H1
    then only removes the locally double-counted veff of rdm1_emb and H0
    absorbs E1.

    veff: optional lattice veff in the LO basis (stripe (spin, R, n, n)),
    typically rebuilt from the correlated GLOBAL density matrix (charge
    self-consistency, embham.update_lattice_csc): the core JK term then
    becomes transform_h1(veff) minus the locally double-counted veff of
    rdm1_emb, instead of the mean-field lattice.JK_core."""
    spin = basis.shape[0]
    nbasis = basis.shape[-1]
    if imp_idx is None:
        imp_idx = list(range(lattice.nimp))
    env_idx = _env_idx(nbasis, imp_idx)
    H2 = ImpHam.H2["ccdd"]
    H2_scaled = get_H2_scaled(H2, imp_idx, env_idx)
    if E1 is not None:
        log.eassert(rdm1_emb is not None, "E1-from-glob needs rdm1_emb")
        veff_loc = embham.get_veff(as_f64(rdm1_emb, basis.device), H2)
        H1_scaled = get_H1_scaled(-veff_loc / spin, imp_idx, env_idx)
        return Integral(nbasis, spin == 1, False,
                        float(np.real(E1)) + lattice.getH0(),
                        {"cd": H1_scaled}, {"ccdd": H2_scaled})
    basis_k = lattice.R2k_basis(basis)
    H1_scaled = embham.transform_h1(lattice.getH1(kspace=True), basis_k)
    if veff is not None:
        # charge self-consistency: JK_core from the provided lattice veff
        # minus the local double counting
        veff = np.asarray(veff)
        if veff.ndim == 3:
            veff = veff[None]
        JK_core = embham.transform_h1(lattice.R2k(veff), basis_k)
        JK_core = JK_core - embham.get_veff(
            as_f64(rdm1_emb, basis.device) * (2.0 / spin), H2)
        H1_scaled = H1_scaled + 0.5 * JK_core
    elif lattice.JK_core is not None:
        H1_scaled = H1_scaled + 0.5 * lattice.JK_core
    if add_vcor_to_E:
        vmat = as_f64(vcor.get(), basis.device)
        for s in range(spin):
            H1_scaled[s] += 0.5 * embham.transform_local(basis[s], vmat[s])
            H1_scaled[s] -= 0.5 * embham.transform_imp(basis[s], vmat[s])
    H1_scaled = get_H1_scaled(H1_scaled, imp_idx, env_idx)
    return Integral(nbasis, spin == 1, False, lattice.getH0(),
                    {"cd": H1_scaled}, {"ccdd": H2_scaled})


def get_E_dmet(basis, lattice, ImpHam, last_dmu, solver, solver_args={},
               **kwargs):
    ImpHam_scaled = get_H_dmet(basis, lattice, ImpHam, last_dmu, **kwargs)
    return solver.run_dmet_ham(ImpHam_scaled, **solver_args)


# ----------------------------------------------------------------------
# chemical-potential fitting
# ----------------------------------------------------------------------

class MuSolver(object):
    """Adaptive chemical-potential fitter over (possibly multiple)
    impurity problems.  The secant / quadratic logic runs on the host on
    the electron counts the solver's densities give."""

    def __init__(self, adaptive=True):
        self.adaptive = adaptive
        self.history = []

    def __call__(self, lattice, filling, ImpHam, basis, solver,
                 solver_args={}, delta=0.02, thrnelec=1e-5, step=0.05,
                 **kwargs):
        filling = np.average(filling)
        single_imp = not isinstance(lattice, (list, tuple))
        if single_imp:
            lattice = [lattice]
            ImpHam = [ImpHam]
            basis = [basis]
            solver = [solver]
            solver_args = [solver_args]
        imp_idx = kwargs.pop("imp_idx", None)
        if imp_idx is None:
            imp_idx = [np.arange(l.nimp) for l in lattice]

        def solve(mu):
            rho_col, E_col = [], []
            ntot = 0.0
            with stage("mu step", basis[0].device, dmu=float(mu)):
                for latt, H, B, sol, sargs, iidx in zip(
                        lattice, ImpHam, basis, solver, solver_args,
                        imp_idx):
                    rho_i, E_i = SolveImpHam_with_dmu(latt, H, B, mu, sol,
                                                      sargs, **kwargs)
                    rho_col.append(rho_i)
                    E_col.append(E_i)
                    ntot += transformResults(rho_i, None, B, None, None,
                                             lattice=latt, imp_idx=iidx)
            return rho_col, E_col, ntot

        def apply_all(dmu):
            return [apply_dmu(l, H, B, dmu, **kwargs)
                    for l, H, B in zip(lattice, ImpHam, basis)]

        target = filling * 2.0
        rho0, E0, n0 = solve(0.0)
        record = [(0.0, n0)]
        log.result("nelec = %20.12f (target %20.12f)", n0, target)

        if abs(n0 / target - 1.0) < thrnelec:
            self.history.append(record)
            res = [rho0, E0, ImpHam, 0.0]
        else:
            if self.adaptive:
                pred = self.predict(n0, target)
                if pred is not None:
                    delta = copysign(min(abs(pred), step), pred)
                else:
                    delta = abs(delta) * (-1 if n0 > target else 1)
            else:
                delta = abs(delta) * (-1 if n0 > target else 1)

            rho1, E1, n1 = solve(delta)
            record.append((delta, n1))
            log.result("nelec = %20.12f (target %20.12f)", n1, target)
            if abs(n1 / target - 1.0) < thrnelec:
                ImpHam = apply_all(delta)
                self.history.append(record)
                res = [rho1, E1, ImpHam, delta]
            else:
                nprime = (n1 - n0) / delta
                delta1 = (target - n0) / nprime
                if abs(delta1) > step:
                    delta1 = copysign(step, delta1)
                rho2, E2, n2 = solve(delta1)
                record.append((delta1, n2))
                log.result("nelec = %20.12f (target %20.12f)", n2, target)
                if abs(n2 / target - 1.0) < thrnelec:
                    ImpHam = apply_all(delta1)
                    self.history.append(record)
                    res = [rho2, E2, ImpHam, delta1]
                else:
                    mus = [0.0, delta, delta1]
                    ns = [n0, n1, n2]
                    res = None
                    for _ in range(2):
                        dnext = quad_fit_mu(np.asarray(mus), np.asarray(ns),
                                            filling, step)
                        rho3, E3, n3 = solve(dnext)
                        record.append((dnext, n3))
                        log.result("nelec = %20.12f (target %20.12f)",
                                   n3, target)
                        mus.append(dnext)
                        ns.append(n3)
                        if abs(n3 / target - 1.0) < thrnelec:
                            break
                    ImpHam = apply_all(dnext)
                    self.history.append(record)
                    res = [rho3, E3, ImpHam, dnext]

        if single_imp:
            res[0] = res[0][0]
            res[1] = res[1][0]
            res[2] = res[2][0]
        return res

    def predict(self, nelec, target):
        """Weighted secant prediction from the fit history: the first two
        points of each earlier record give a slope, weighted by recency
        and by how close that record's counts were to this one's."""
        vals, weights = [], []
        damp = np.e
        sigma2 = 0.00025
        for i, record in enumerate(self.history):
            if len(record) < 2:
                continue
            weight = damp ** (i + 1 - len(self.history))
            (mu1, n1), (mu2, n2) = record[0], record[1]
            if abs(mu2 - mu1) < 1e-12 or abs(n2 - n1) < 1e-12:
                continue
            slope = (n2 - n1) / (mu2 - mu1)
            val = (target - nelec) / slope
            metric = min((target - n1) ** 2 + (nelec - n2) ** 2,
                         (target - n2) ** 2 + (nelec - n1) ** 2)
            weight *= exp(-0.5 * metric / sigma2)
            vals.append(val)
            weights.append(weight)
        if np.sum(weights) > 1e-3:
            dmu = np.dot(vals, weights) / np.sum(weights)
            if abs(dmu) > 0.5:
                dmu = copysign(0.5, dmu)
            return dmu
        return None

    def save(self, filename):
        with open(filename, "wb") as f:
            pickle.dump(self.history, f)

    def load(self, filename):
        if os.path.exists(filename):
            with open(filename, "rb") as f:
                self.history = pickle.load(f)


SolveImpHam_with_fitting = MuSolver(adaptive=True)


# ----------------------------------------------------------------------
# vcor initial guesses
# ----------------------------------------------------------------------


def AFInitGuess(ImpSize, U, Filling, polar=None, bogoliubov=False, rand=0.0,
                subA=None, subB=None, trace_zero=False, d_wave=False,
                bogo_res=False):
    if subA is None and subB is None:
        subA, subB = BipartiteSquare(ImpSize)
    nscsites = len(subA) + len(subB)
    shift = U * Filling
    if polar is None:
        polar = shift * Filling
    init_v = np.eye(nscsites) * shift
    if trace_zero:
        init_v[:] = 0.0
    init_p = np.zeros_like(init_v)
    for i in range(nscsites):
        if i in subA:
            init_p[i, i] = polar
        elif i in subB:
            init_p[i, i] = -polar
    v = VcorLocal(False, bogoliubov, nscsites, bogo_res=bogo_res)
    if bogoliubov:
        # the same seeded NumPy stream as the JAX package, so both
        # packages start from the same vcor
        rng = np.random.RandomState(32499823)
        init_d = (rng.rand(nscsites, nscsites) - 0.5) * rand
        v.assign(np.asarray([init_v + init_p, init_v - init_p, init_d]))
    else:
        v.assign(np.asarray([init_v + init_p, init_v - init_p]))
    return v


def PMInitGuess(ImpSize, U, Filling, bogoliubov=False, rand=0.0):
    nscsites = int(np.prod(ImpSize))
    shift = U * Filling
    init_v = np.eye(nscsites) * shift
    v = VcorLocal(True, bogoliubov, nscsites)
    if bogoliubov:
        init_d = np.zeros((nscsites, nscsites))
        v.assign(np.asarray([init_v, init_v, init_d]))
    else:
        v.assign(np.asarray([init_v, init_v]))
    if rand > 0.0:
        rng = np.random.RandomState(32499823)
        v.update(v.param + (rng.rand(v.length()) - 0.5) * rand)
    return v


# ----------------------------------------------------------------------
# vcor fit wrapper
# ----------------------------------------------------------------------

def FitVcor(rho, lattice, basis, vcor, beta, filling=0.5, MaxIter1=300,
            MaxIter2=0, **kwargs):
    return fit_mod.FitVcorTwoStep(rho, lattice, basis, vcor, beta, filling,
                                  MaxIter1=MaxIter1, MaxIter2=MaxIter2,
                                  **kwargs)


# ----------------------------------------------------------------------
# bookkeeping
# ----------------------------------------------------------------------

class IterHistory(object):
    def __init__(self):
        self.history = []

    def update(self, energy, err, nelec, dvcor, dc):
        if not self.history:
            self.history.append([energy, energy, err, nelec, dvcor,
                                 dc.nDim, dc.iNext])
        else:
            self.history.append([energy, energy - self.history[-1][0], err,
                                 nelec, dvcor, dc.nDim, dc.iNext])
        log.section("\nDMET Progress\n")
        log.result("  Iter         Energy                 dE"
                   "                RdmErr               Nelec"
                   "                 dVcor      DIIS")
        for idx, item in enumerate(self.history):
            log.result(" %3d %20.12f %15.3e %20.12f %20.12f %20.5e %2d %2d",
                       idx, *item)

    def write_table(self, filename="./table.txt"):
        with open(filename, "w") as f:
            f.write("  Iter  Energy  dE  RdmErr  Nelec  dVcor  DIIS\n")
            for idx, item in enumerate(self.history):
                f.write(" %3d %20.12f %15.3e %20.12f %20.12f %20.5e %2d %2d\n"
                        % ((idx,) + tuple(item)))
