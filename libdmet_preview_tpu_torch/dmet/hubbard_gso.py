"""
GSO (spinless / superconducting) DMET facade (PyTorch port of
libdmet_preview_tpu/dmet/hubbard_gso.py).

Workflow:
  GH1, GH0   = spinless.transform_H1_k(lattice H1(k))
  GV2, GV1, GV0 = spinless.transform_H2_local(lattice H2)
  GRho, mu   = GHartreeFock(...)          # mu fit to the physical filling
  basis      = ConstructImpHam -> spinless bath + embedding Integral
  solve with FCI(ghf=True) under a dmu loop fixing the impurity's
  physical electron count, then transformResults.

The lattice operators stay host NumPy (set-up sized); the mean field, the
bath, the embedding Hamiltonian and the solves run on the lattice's
device (set_Ham's, the card by default).
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.ops import spinless
from libdmet_preview_tpu_torch.models.integral import Integral
from libdmet_preview_tpu_torch.models.lattice import (  # noqa: F401
    ChainLattice, SquareLattice, CubicLattice)
from libdmet_preview_tpu_torch.models.hamiltonian import (  # noqa: F401
    HubbardHamiltonian as Ham)


class GSOHam(object):
    """Transformed (spinless) lattice Hamiltonian bundle.

    Works on model lattices (local H2) and on ab initio 'cholesky'
    lattices: in the non-interacting-bath flavour the impurity-cell ERI
    block (local) is the ph-transformed interaction; with int_bath=True
    the full-lattice Cholesky factors carry it, with GV1 / GV0 their
    normal-ordering terms against the filled-beta sea, and the mean field
    runs on the ph transform of the PHYSICAL Fock."""

    def __init__(self, lattice, vcor_mat3=None, use_hcore=True,
                 int_bath=False):
        self.int_bath = bool(int_bath)
        H1_k = lattice.getH1(kspace=True) if (use_hcore or int_bath) \
            else lattice.getFock(kspace=True)
        GH1_c, GH0_H1 = spinless.transform_H1_k(H1_k)
        self.GH1_k = spinless.combine_H1_k(GH1_c)          # (nk, nso, nso)
        self.GH0 = GH0_H1
        self.lattice = lattice
        self.nao = nao = lattice.nao
        self.nso = 2 * lattice.nao
        self.JK_core = None
        if int_bath:
            log.eassert(lattice.H2_format == "cholesky",
                        "GSO interacting bath needs the cholesky format")
            L = lattice.getH2()
            self.chol_L = L
            ncells = lattice.ncells
            GV1_sc, GV0_sc = spinless.get_GV1_GV0_from_chol(L)
            self.GV0 = GV0_sc / ncells
            self.GV2 = self.GV1 = None
            # supercell GV1 -> translation stripes (block column 0) -> k
            stripes = GV1_sc.reshape(3, ncells, nao, ncells, nao)[:, :, :,
                                                                  0, :]
            gv1_re, gv1_im = lattice.R2k(stripes)
            re = self.GH1_k[0].copy()
            im = self.GH1_k[1].copy()
            re[:, :nao, :nao] += gv1_re[0]
            im[:, :nao, :nao] += gv1_im[0]
            re[:, nao:, nao:] += gv1_re[1]
            im[:, nao:, nao:] += gv1_im[1]
            re[:, :nao, nao:] += gv1_re[2]
            im[:, :nao, nao:] += gv1_im[2]
            re[:, nao:, :nao] += gv1_re[2].transpose(0, 2, 1)
            im[:, nao:, :nao] -= gv1_im[2].transpose(0, 2, 1)
            self.GH1_full_k = (re, im)
            GF_c, _ = spinless.transform_H1_k(lattice.getFock(kspace=True))
            self.GFock_k = spinless.combine_H1_k(GF_c)
            return
        if lattice.H2_format == "local":
            H2_loc = np.asarray(lattice.getH2(kspace=False))
        elif lattice.H2_format == "cholesky":
            H2_loc = np.asarray(lattice.Ham.eri_imp)
        else:
            raise ValueError("GSO path: local or cholesky H2 required")
        self.GV2, self.GV1, self.GV0 = spinless.transform_H2_local(H2_loc)

    def H0_total(self, mu):
        """Constant of H_phys - mu N_phys in the transformed frame, per
        cell: GH0 + GV0 - mu*nao."""
        return self.GH0 + self.GV0 - mu * self.nao


def GHartreeFock(gham, filling, mu0=0.0, vcor_mat=None, beta=np.inf,
                 **kwargs):
    """Mean field of the transformed lattice with a physical-mu fit.

    GV1 (the one-body term of the interaction's ph transform) does not
    enter the bare mean field: it belongs to the (impurity-truncated)
    embedding interaction.  With the interacting bath the mean field is
    the ph transform of the physical Fock.  Returns (GRho_R, mu, res)."""
    nso = gham.nso
    vmat = np.zeros((nso, nso)) if vcor_mat is None else vcor_mat
    GH1 = gham.GFock_k if gham.int_bath else gham.GH1_k
    return spinless.GHF_mu_fit(gham.lattice, GH1, vmat, filling, mu0=mu0,
                               beta=beta, **kwargs)


def ConstructImpHam(gham, GRho_R, mu, vcor_mat=None, GRho_k=None, **kwargs):
    """Spinless bath and embedding Integral; returns (ImpHam, None, basis).
    With the interacting bath the core JK potential is kept on gham
    (gham.JK_core) for the energy."""
    lattice = gham.lattice
    with stage("bath", lattice.device):
        basis = spinless.get_emb_basis(lattice, GRho_R, **kwargs)
    # H0 carries only the PHYSICAL per-cell constants (lattice H0, e.g.
    # e_nuc/cell, + the ph-transform constants GH0 + GV0); the mu
    # operator terms are cancelled inside transform_results
    H0 = float(lattice.getH0()) + gham.GH0 + gham.GV0
    if gham.int_bath:
        if GRho_k is None:
            GRho_R_a = np.asarray(GRho_R)
            if GRho_R_a.ndim == 4:
                GRho_R_a = GRho_R_a[0]
            GRho_k = lattice.R2k(GRho_R_a)
        ImpHam, JK_core = spinless.get_emb_Ham_ib(
            lattice, basis, gham.GFock_k, gham.GH1_full_k, gham.chol_L, H0,
            mu, GRho_k, vcor_gso=vcor_mat)
        gham.JK_core = JK_core
        return ImpHam, None, basis
    with stage("embedding Hamiltonian", lattice.device):
        ImpHam = spinless.get_emb_Ham(lattice, basis, gham.GH1_k, gham.GV2,
                                      gham.GV1, H0, mu, vcor_gso=vcor_mat,
                                      **kwargs)
    return ImpHam, None, basis


apply_dmu = spinless.apply_dmu


def SolveImpHam_with_fitting(gham, filling, ImpHam, basis, solver,
                             solver_args=None, dmu0=0.0, thrnelec=1e-5,
                             max_iter=12, step=0.2):
    """Adaptive dmu fit: secant iteration on the impurity-cell physical
    electron count.  Returns (rdm, E, the Integral with dmu applied,
    dmu)."""
    solver_args = dict(solver_args or {})
    nao = gham.nao
    neo = basis.shape[-1]
    nelec_T = neo // 2
    target = filling * 2.0 * nao

    def solve(dmu):
        Ham_d = copy_integral(ImpHam)
        Ham_d = spinless.apply_dmu(gham.lattice, Ham_d, basis, dmu)
        rdm, E = solver.run(Ham_d, nelec=nelec_T, **solver_args)
        _, _, n = spinless.transform_results(rdm, None, basis, Ham_d,
                                             gham.lattice, 0.0)
        return rdm, E, n * nao, Ham_d

    dmu = dmu0
    rdm, E, n, Ham_d = solve(dmu)
    if abs(n - target) < thrnelec:
        return rdm, E, Ham_d, dmu
    dmu_old, n_old = dmu, n
    dmu = dmu + (step if n < target else -step)
    for it in range(max_iter):
        rdm, E, n, Ham_d = solve(dmu)
        if abs(n - target) < thrnelec:
            break
        if abs(n - n_old) > 1e-12:
            dmu_new = dmu + (target - n) * (dmu - dmu_old) / (n - n_old)
        else:
            dmu_new = dmu + (step if n < target else -step)
        dmu_old, n_old = dmu, n
        dmu = float(np.clip(dmu_new, dmu - 1.0, dmu + 1.0))
    return rdm, E, Ham_d, dmu


def copy_integral(Ham):
    """An Integral with copies of Ham's H1 and H2 blocks."""
    def copy(x):
        return x.clone() if hasattr(x, "clone") else np.array(x, copy=True)

    return Integral(Ham.norb, Ham.restricted, Ham.bogoliubov, Ham.H0,
                    {"cd": copy(Ham.H1["cd"])},
                    {"ccdd": copy(Ham.H2["ccdd"])}, ovlp=Ham.ovlp)


def transformResults(GRhoEmb, E_emb, basis, ImpHam, gham, mu, last_dmu=0.0,
                     solver=None, solver_args=None, **kwargs):
    """(GRhoImp tensor, E per site, nelec per site).  With the interacting
    bath and a solver, E is re-evaluated on the democratically scaled GSO
    Hamiltonian (spinless.get_E_dmet_ib)."""
    if gham.int_bath and "JK_core" not in kwargs:
        kwargs["JK_core"] = gham.JK_core
    GRhoImp, Efrag, n = spinless.transform_results(
        GRhoEmb, E_emb, basis, ImpHam, gham.lattice, mu,
        last_dmu=last_dmu, **kwargs)
    if gham.int_bath and Efrag is not None and solver is not None:
        H0 = float(gham.lattice.getH0()) + gham.GH0 + gham.GV0
        Efrag = spinless.get_E_dmet_ib(
            gham.lattice, basis, gham.GH1_full_k, gham.JK_core, ImpHam,
            H0, solver, solver_args) / gham.nao
    return GRhoImp, Efrag, n
