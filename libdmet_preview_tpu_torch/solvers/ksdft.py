"""
Molecular KS-DFT (LDA / LSDA / PBE, DFT+U) on the port's Gaussian engine
(PyTorch port of libdmet_preview_tpu/solvers/ksdft.py).

The SCF runs on `device`: the Becke grid and the AO values on it
(ints.grid), J and K as two matrix-vector products over the (nao,)^4 ERI
(laid out once for each), the XC energy and its autograd potential
(ints.xc), the symmetric orthogonalizer and eigh.  DIIS is the port's host
copy (ops.diis.DIIS): one read of the Fock matrix and the commutator per
iteration, plus the energy for the stopping test |dE| < conv_tol (after
the second iteration), which keeps the JAX package's iterates one for one.

Used to prepare a KS lattice (fock = hcore + J + vxc) for DFT-in-DMET,
with the xc double counting in ops.embham._emb_H1 (models.abinitio.
attach_ks).  Each SCF iteration's parts are utils.timer stages: "KS J/K",
"KS XC", "KS +U", "KS DIIS" and "KS eigh".
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.ints.grid import becke_grid, eval_ao, \
    eval_ao_grad
from libdmet_preview_tpu_torch.ints.xc import eval_exc_vxc, is_gga
from libdmet_preview_tpu_torch.ops.diis import DIIS
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage


class _KSBase(object):
    """Grid, AO values and integrals shared by RKS and UKS."""

    def __init__(self, mol, xc, n_rad, n_theta, n_phi, max_cycle, conv_tol,
                 device):
        self.mol = mol
        self.xc = xc
        self.max_cycle = max_cycle
        self.conv_tol = conv_tol
        self.device = torch.device(device)
        self.grid = becke_grid(mol, n_rad=n_rad, n_theta=n_theta,
                               n_phi=n_phi, device=self.device)
        self.ao_g = eval_ao(mol, self.grid[0])
        self.ao_grad_g = eval_ao_grad(mol, self.grid[0]) \
            if is_gga(xc) else None
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.dm = None
        self.converged = False
        self.cycles = 0

    def _integrals(self):
        """hcore, S and the symmetric orthogonalizer S^{-1/2} on the
        device, also kept as _h, _S, _A, and the ERI laid out for J and
        for K."""
        mol, dev = self.mol, self.device
        h = as_f64(mol.intor_hcore(), dev)
        S = as_f64(mol.intor_ovlp(), dev)
        eri = as_f64(mol.intor_eri(), dev)
        n = mol.nao
        self._eri = eri.reshape(n * n, n * n)
        # K[p, q] = sum_rs (pr|qs) D_rs: the (pr|qs) layout, made once
        self._eri_k = eri.permute(0, 2, 1, 3).reshape(n * n, n * n)
        w, v = torch.linalg.eigh(S)
        A = (v * w ** -0.5) @ v.T
        self._h, self._S, self._A = h, S, A
        return h, S, A

    def _jk(self, dm):
        """(J, K) of one density matrix (after kernel has run)."""
        shape = dm.shape
        d = as_f64(dm, self.device).reshape(-1)
        return ((self._eri @ d).reshape(shape),
                (self._eri_k @ d).reshape(shape))

    def _plus_u(self, dm):
        """Hubbard-U hook (overridden by RKSpU / UKSpU); (E_U, v_U)."""
        return 0.0, 0.0

    @staticmethod
    def _diis(diis, f, err):
        with stage("KS DIIS", f.device):
            out = diis.update(f.cpu().numpy(), err.cpu().numpy())
            return torch.as_tensor(out.reshape(f.shape), device=f.device)


class RKS(_KSBase):
    """Restricted KS: run() -> converged (E_tot, dm_total), dm a tensor on
    `device`.

    xc: 'lsda' (Slater X + VWN5 C), 'slater' (X only), 'lda_pw', 'pbe', or
    None (J only, exchange-free; with hyb=1 this is RHF)."""

    def __init__(self, mol, xc="lsda", hyb=0.0, n_rad=60, n_theta=12,
                 n_phi=24, max_cycle=60, conv_tol=1e-9,
                 device=torch.device("cuda")):
        super().__init__(mol, xc, n_rad, n_theta, n_phi, max_cycle, conv_tol,
                         device)
        self.hyb = float(hyb)

    def _xc(self, dm):
        if self.xc is None:
            return 0.0, torch.zeros_like(dm)
        with stage("KS XC", dm.device):
            return eval_exc_vxc(dm, self.ao_g, self.grid[1], restricted=True,
                                xc=self.xc, ao_grad=self.ao_grad_g)

    def _occupied_dm(self, A, f, nocc):
        with stage("KS eigh", f.device):
            e, c = torch.linalg.eigh(A @ f @ A)
            C = A @ c
            return e, C, 2.0 * C[:, :nocc] @ C[:, :nocc].T

    def _fock_parts(self, dm):
        with stage("KS J/K", dm.device):
            vj, vk = self._jk(dm)
        exc, vxc = self._xc(dm)
        with stage("KS +U", dm.device):
            eU, vU = self._plus_u(dm)
        return vj, vk, exc, vxc, eU, vU

    def kernel(self, dm0=None):
        mol = self.mol
        h, S, A = self._integrals()
        nocc = mol.nelectron // 2
        assert mol.nelectron % 2 == 0, "RKS needs a closed shell"
        if dm0 is None:
            e, C, dm = self._occupied_dm(A, h, nocc)
        else:
            dm = as_f64(dm0, self.device)
        e_nuc = mol.energy_nuc()
        diis = DIIS(space=8)
        e_old = 0.0
        self.converged = False
        for it in range(self.max_cycle):
            vj, vk, exc, vxc, eU, vU = self._fock_parts(dm)
            f = h + vj + vxc + vU
            if self.hyb != 0.0:
                f = f - 0.5 * self.hyb * vk
                exc = exc - 0.25 * self.hyb * float(torch.sum(vk * dm))
            # DIIS on the commutator residual
            err = f @ dm @ S - S @ dm @ f
            f = self._diis(diis, f, err)
            e, C, dm = self._occupied_dm(A, f, nocc)
            e_tot = float(torch.sum(h * dm) + 0.5 * torch.sum(vj * dm)) \
                + exc + eU + e_nuc
            if abs(e_tot - e_old) < self.conv_tol and it > 1:
                self.converged = True
                break
            e_old = e_tot
        self.cycles = it + 1
        self.e_tot = e_tot
        self.mo_coeff = C
        self.mo_energy = e
        self.dm = dm
        # final potentials for downstream consumers (fock pieces)
        vj, vk, exc, vxc, eU, vU = self._fock_parts(dm)
        self.vj, self.vk, self.exc, self.vxc = vj, vk, exc, vxc
        self.E_U = eU
        self.fock = h + vj + vxc + vU - (0.5 * self.hyb) * vk
        return self.e_tot, dm

    run = kernel


class UKS(_KSBase):
    """Unrestricted KS: run() -> (E_tot, (2, nao, nao) dm tensor)."""

    def __init__(self, mol, xc="lsda", nelec=None, n_rad=60, n_theta=12,
                 n_phi=24, max_cycle=80, conv_tol=1e-9,
                 device=torch.device("cuda")):
        super().__init__(mol, xc, n_rad, n_theta, n_phi, max_cycle, conv_tol,
                         device)
        self.nelec = nelec     # (na, nb)

    def kernel(self, dm0=None):
        mol = self.mol
        h, S, A = self._integrals()
        if self.nelec is None:
            na = (mol.nelectron + 1) // 2
            nb = mol.nelectron - na
        else:
            na, nb = self.nelec
        if dm0 is None:
            e, c = torch.linalg.eigh(A @ h @ A)
            C = A @ c
            dm = torch.stack([C[:, :na] @ C[:, :na].T,
                              C[:, :nb] @ C[:, :nb].T])
        else:
            dm = as_f64(dm0, self.device)
        e_nuc = mol.energy_nuc()
        diis = DIIS(space=8)
        e_old = 0.0
        self.converged = False
        for it in range(self.max_cycle):
            with stage("KS J/K", dm.device):
                vj = self._jk(dm.sum(0))[0]
            with stage("KS XC", dm.device):
                exc, vxc = eval_exc_vxc(dm, self.ao_g, self.grid[1],
                                        restricted=False, xc=self.xc,
                                        ao_grad=self.ao_grad_g)
            with stage("KS +U", dm.device):
                eU, vU = self._plus_u(dm)
            if not isinstance(vU, torch.Tensor):
                vU = torch.zeros_like(dm)
            f = torch.stack([h + vj + vxc[0] + vU[0],
                             h + vj + vxc[1] + vU[1]])
            err = torch.cat([f[s] @ dm[s] @ S - S @ dm[s] @ f[s]
                             for s in range(2)], dim=0)
            f = self._diis(diis, f, err)
            dm_new, mo_e, mo_c = [], [], []
            with stage("KS eigh", dm.device):
                for s, n in ((0, na), (1, nb)):
                    e, c = torch.linalg.eigh(A @ f[s] @ A)
                    C = A @ c
                    dm_new.append(C[:, :n] @ C[:, :n].T)
                    mo_e.append(e)
                    mo_c.append(C)
            dm = torch.stack(dm_new)
            e_tot = float(torch.sum(h * dm.sum(0))
                          + 0.5 * torch.sum(vj * dm.sum(0))) \
                + exc + eU + e_nuc
            if abs(e_tot - e_old) < self.conv_tol and it > 1:
                self.converged = True
                break
            e_old = e_tot
        self.cycles = it + 1
        self.e_tot = e_tot
        self.mo_coeff = torch.stack(mo_c)
        self.mo_energy = torch.stack(mo_e)
        self.dm = dm
        self.exc = exc
        return self.e_tot, dm

    run = kernel


def _dudarev(P, U):
    """Dudarev rotationally invariant +U on ONE per-spin local block P (a
    tensor): (E, dE/dP) = (U/2 (tr P - tr P^2 / 2), U/2 (1 - P))."""
    eye = torch.eye(P.shape[0], dtype=P.dtype, device=P.device)
    E = (U * 0.5) * (torch.trace(P) - 0.5 * torch.sum(P * P.T))
    return E, (U * 0.5) * (eye - 0.5 * (P + P.T))


class _PlusU(object):
    """The local-orbital projectors SC = S C_ao_lo of a +U driver."""

    def _set_projectors(self, mol, C_ao_lo, U_idx, U_val):
        S = as_f64(mol.intor_ovlp(), self.device)
        self.SC = S @ as_f64(C_ao_lo, self.device)
        self.U_idx = [torch.as_tensor(np.asarray(ix, dtype=np.int64),
                                      device=self.device) for ix in U_idx]
        self.U_val = [float(u) for u in U_val]


class RKSpU(_PlusU, RKS):
    """Restricted KS-DFT+U: the Dudarev simplified rotationally invariant
    correction on local-orbital projectors:
    v_U = SC [(U/2)(1 - P)] (SC)^T per spin,
    E_U = sum (U/2)(tr P - tr P^2 / 2) per spin,
    P the per-spin local-orbital occupation block.

    C_ao_lo: (nao, nlo) local orbitals (Lowdin / IAO).  U_idx: list of
    LO-index lists; U_val: matching U (hartree)."""

    def __init__(self, mol, C_ao_lo, U_idx, U_val, **kwargs):
        super().__init__(mol, **kwargs)
        self._set_projectors(mol, C_ao_lo, U_idx, U_val)

    def _plus_u(self, dm):
        dm = as_f64(dm, self.device)
        vU = torch.zeros_like(dm)
        E_U = dm.new_zeros(())
        for idx, U in zip(self.U_idx, self.U_val):
            SCi = self.SC[:, idx]
            P = 0.5 * (SCi.T @ dm @ SCi)          # per-spin block
            E, dE = _dudarev(P, U)
            E_U = E_U + 2.0 * E                    # two equal spins
            vU = vU + SCi @ dE @ SCi.T             # dP/d(dm) carries 1/2
        return float(E_U), vU


class UKSpU(_PlusU, UKS):
    """Unrestricted KS-DFT+U: per-spin Dudarev blocks on the same local
    projectors."""

    def __init__(self, mol, C_ao_lo, U_idx, U_val, **kwargs):
        super().__init__(mol, **kwargs)
        self._set_projectors(mol, C_ao_lo, U_idx, U_val)

    def _plus_u(self, dm):
        dm = as_f64(dm, self.device)
        vU = torch.zeros_like(dm)
        E_U = dm.new_zeros(())
        for idx, U in zip(self.U_idx, self.U_val):
            SCi = self.SC[:, idx]
            for s in range(2):
                P = SCi.T @ dm[s] @ SCi
                E, dE = _dudarev(P, U)
                E_U = E_U + E
                vU[s] = vU[s] + SCi @ dE @ SCi.T
        return float(E_U), vU
