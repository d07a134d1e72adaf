"""
J and K matrices for model-lattice Hamiltonians (PyTorch port of
get_jk_local, get_jk_nearest and get_jk_full_bruteforce of
libdmet_preview_tpu/ops/pbc_helper.py; the k-resolved 7d, GDF and GHF
versions belong to the ab initio and GSO slices).
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64


def _jk_local(eri, dm):
    vj = torch.einsum("ijkl, skl -> sij", eri, dm)
    vk = torch.einsum("ilkj, skl -> sij", eri, dm)
    return vj, vk


def get_jk_local(eri, dm0, device):
    """J/K from a local (single-cell) ERI and the cell-averaged density
    rho(R=0), contracted on `device`.  Both are k-independent.

    dm0: (spin, nao, nao) real.  Returns host (vj, vk) with shape
    (spin, nao, nao), like the lattice operators they update."""
    dm0 = np.asarray(dm0)
    if dm0.ndim == 2:
        dm0 = dm0[None]
    vj, vk = _jk_local(as_f64(eri, device), as_f64(dm0, device))
    return vj.cpu().numpy(), vk.cpu().numpy()


def get_jk_nearest(eri_R, dm_stripe, device):
    """J/K for the 'nearest' H2 format, contracted on `device`.

    eri_R: (ncells, n, n, n, n) blocks (0 p 0 q | R r R s); dm_stripe:
    (spin, ncells, n, n) with block (ci, cj) = dm[ci - cj].  vj is local
    (the density is the same in every cell), vk is a stripe:
      vj[p, q]    = sum_R eri_R[R, p, q, r, s] dm0[s, r]
      vk[R][p, s] = sum   eri_R[R, p, q, r, s] dm[R][r, q]
    Returns host (vj (spin, n, n), vk (spin, ncells, n, n))."""
    dm_stripe = np.asarray(dm_stripe)
    if dm_stripe.ndim == 3:
        dm_stripe = dm_stripe[None]
    eri_R = as_f64(eri_R, device)
    dm = as_f64(dm_stripe, device)
    vj = torch.einsum("Rpqrs, tsr -> tpq", eri_R, dm[:, 0])
    vk = torch.einsum("Rpqrs, tRrq -> tRps", eri_R, dm)
    return vj.cpu().numpy(), vk.cpu().numpy()


def get_jk_full_bruteforce(lattice, eri_R, dm_stripe):
    """Oracle J/K from the fully expanded supercell ERI ('nearest' blocks
    expanded to (nsites,) * 4), on the host: the test reference of
    get_jk_nearest."""
    ncells, n = eri_R.shape[0], eri_R.shape[1]
    ns = ncells * n
    big = np.zeros((ns,) * 4)
    for cI in range(ncells):
        for cR in range(ncells):
            cJ = lattice.add(cI, cR)
            big[cI * n:(cI + 1) * n, cI * n:(cI + 1) * n,
                cJ * n:(cJ + 1) * n, cJ * n:(cJ + 1) * n] = eri_R[
                    lattice.subtract(cJ, cI)]
    dm_full = lattice.expand(np.asarray(dm_stripe))
    vj = np.einsum("pqrs, tsr -> tpq", big, dm_full)
    vk = np.einsum("pqrs, trq -> tps", big, dm_full)
    return vj, vk
