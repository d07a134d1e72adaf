"""
Hubbard-U correction on the lattice mean field (PyTorch port of
libdmet_preview_tpu/ops/dftu.py): the simplified rotationally invariant
(Dudarev) form

    v_U(k) = SC [ (U/2) (1 - P_k) ] (SC)^H          (per spin)
    E_U    = sum_k w_k (U/2) (tr P_k - tr P_k^2 / 2)

with P_k the local-orbital block of the per-spin k-space density.  In an
orthonormal LO basis the projector SC is a column selection.  The
k-resolved densities and potentials keep the JAX package's (re, im) pair
I/O (host arrays of shape (spin, nk, nlo, nlo)); HF_plus_U iterates the
port's lattice mean field (ops.mfd.HF) on the lattice's device.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


def hub_u_correction(rdm1_lo_k, U_idx, U_val):
    """+U potential and energy from a per-spin k-resolved LO density.

    rdm1_lo_k: (re, im) pair, shape (spin, nk, nlo, nlo), PER-SPIN
    densities (restricted input: pass the half density, spin dim 1).
    U_idx: list of orbital-index lists (one per correlated subspace);
    U_val: matching U values (hartree).

    Returns ((vU_re, vU_im) with shape (spin, nk, nlo, nlo), E_U)."""
    r_re = np.asarray(rdm1_lo_k[0])
    r_im = np.asarray(rdm1_lo_k[1])
    if r_re.ndim == 3:
        r_re, r_im = r_re[None], r_im[None]
    spin, nk, nlo, _ = r_re.shape
    vU_re = np.zeros_like(r_re)
    vU_im = np.zeros_like(r_im)
    E_U = 0.0
    w = 1.0 / nk
    for idx, val in zip(U_idx, U_val):
        mesh = np.ix_(range(spin), range(nk), idx, idx)
        P_re = r_re[mesh]
        P_im = r_im[mesh]
        eye = np.eye(len(idx))
        vU_re[mesh] += (val * 0.5) * (eye[None, None] - P_re)
        vU_im[mesh] += (val * 0.5) * (-P_im)
        trP = np.einsum("skii ->", P_re)
        # tr(P^2) for Hermitian complex P = sum |P|^2
        trP2 = np.einsum("skij, skij ->", P_re, P_re) \
            + np.einsum("skij, skij ->", P_im, P_im)
        E_U += w * (val * 0.5) * (trP - 0.5 * trP2)
    # restricted convention: both spins contribute equally
    if spin == 1:
        E_U *= 2.0
    return (vU_re, vU_im), float(E_U)


class _UVcor(object):
    """vcor wrapper for the lattice mean field: a base vcor (or None) plus
    the k-resolved +U potential, as a non-local (re, im) k-space vcor."""

    def __init__(self, base, vU, restricted):
        self.base = base
        self.vU = vU
        self.restricted = restricted

    def islocal(self):
        return False

    def get(self, i=0, kspace=True):
        assert kspace
        spin = 1 if self.restricted else 2
        v_re = np.array(self.vU[0], copy=True)
        v_im = np.array(self.vU[1], copy=True)
        if self.base is not None:
            vb = np.asarray(self.base.get())[:spin]
            v_re += vb[:, None]
        return v_re, v_im


def HF_plus_U(lattice, vcor, filling, restricted, U_idx, U_val, mu0=None,
              beta=np.inf, max_cycle=50, conv_tol=1e-10, **kwargs):
    """Self-consistent lattice mean field with the +U correction.

    Returns (rho_R, mu, E_tot) with E_tot including E_U (the Dudarev form
    carries its own double counting)."""
    from libdmet_preview_tpu_torch.ops import mfd

    spin = 1 if restricted else 2
    nlo = lattice.nscsites
    nk = lattice.ncells
    vU = (np.zeros((spin, nk, nlo, nlo)), np.zeros((spin, nk, nlo, nlo)))
    E_old, E_U = np.inf, 0.0
    out = None
    for it in range(max_cycle):
        rho_R, mu, E, res = mfd.HF(lattice, _UVcor(vcor, vU, restricted),
                                   filling, restricted, mu0=mu0, beta=beta,
                                   ires=True, **kwargs)
        rho_k = (np.asarray(res["rho_k"][0]), np.asarray(res["rho_k"][1]))
        vU, E_U = hub_u_correction(rho_k, U_idx, U_val)
        # mfd.HF's energy EXCLUDES non-local vcor contributions (its E uses
        # the bare lattice Fock), so the +U total energy is simply E + E_U
        E_tot = E + E_U
        out = (rho_R, mu, E_tot)
        if abs(E_tot - E_old) < conv_tol:
            break
        E_old = E_tot
    log.info("HF+U: converged in %d cycles, E = %.12f (E_U = %.8f)",
             it + 1, E_tot, E_U)
    return out
