"""
J and K matrices for lattice Hamiltonians (PyTorch port of
libdmet_preview_tpu/ops/pbc_helper.py: get_jk_local, get_jk_nearest,
get_jk_full_bruteforce, the k-resolved functions eri_R_to_eri_7d,
get_jk_from_eri_7d, get_jk_from_gdf, eri_to_gdf, and the generalized-spin
get_jk_ghf).

The k-resolved functions work on complex128 tensors on `device`.  They
do momentum algebra on the flattened k index ((k + q) % nk), which is the
lattice's own on a 1D cyclic mesh only.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64


def _jk_local(eri, dm):
    vj = torch.einsum("ijkl, skl -> sij", eri, dm)
    vk = torch.einsum("ilkj, skl -> sij", eri, dm)
    return vj, vk


def get_jk_local(eri, dm0, device=torch.device("cuda")):
    """J/K from a local (single-cell) ERI and the cell-averaged density
    rho(R=0), contracted on `device`.  Both are k-independent.

    dm0: (spin, nao, nao) real.  Returns host (vj, vk) with shape
    (spin, nao, nao), like the lattice operators they update."""
    dm0 = np.asarray(dm0)
    if dm0.ndim == 2:
        dm0 = dm0[None]
    vj, vk = _jk_local(as_f64(eri, device), as_f64(dm0, device))
    return vj.cpu().numpy(), vk.cpu().numpy()


def get_jk_nearest(eri_R, dm_stripe, device=torch.device("cuda"),
                   neg_map=None):
    """J/K for the 'nearest' H2 format, contracted on `device`.

    eri_R: (ncells, n, n, n, n) blocks (0 p 0 q | R r R s); dm_stripe:
    (spin, ncells, n, n) with block (ci, cj) = dm[ci - cj].  vj is local
    (the density is the same in every cell), vk is a stripe:
      vj[p, q]    = sum_R eri_R[R, p, q, r, s] dm0[s, r]
      vk[R][p, s] = sum   eri_R[R, p, q, r, s] dm[R][r, q]
    neg_map: the JAX package's argument, (ncells,) cell index of -R.  vk
    reads dm[R] itself, so no negation enters; a given map is checked to
    be a negation map as LatticeModel._neg_map is one (a permutation that
    is its own inverse and keeps cell 0), and ValueError is raised if not.
    Returns host (vj (spin, n, n), vk (spin, ncells, n, n))."""
    dm_stripe = np.asarray(dm_stripe)
    if dm_stripe.ndim == 3:
        dm_stripe = dm_stripe[None]
    if neg_map is not None:
        _check_neg_map(neg_map, dm_stripe.shape[1])
    eri_R = as_f64(eri_R, device)
    dm = as_f64(dm_stripe, device)
    vj = torch.einsum("Rpqrs, tsr -> tpq", eri_R, dm[:, 0])
    vk = torch.einsum("Rpqrs, tRrq -> tRps", eri_R, dm)
    return vj.cpu().numpy(), vk.cpu().numpy()


def _check_neg_map(neg_map, ncells):
    m = np.asarray(neg_map)
    if not (m.shape == (ncells,) and np.issubdtype(m.dtype, np.integer)
            and np.array_equal(np.sort(m), np.arange(ncells))
            and np.array_equal(m[m], np.arange(ncells)) and m[0] == 0):
        raise ValueError("neg_map is not a map R -> -R of %d cells (a "
                         "permutation that is its own inverse and keeps "
                         "cell 0, as LatticeModel._neg_map)" % ncells)


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


# ----------------------------------------------------------------------
# k-resolved J and K (1D cyclic mesh)
# ----------------------------------------------------------------------

def _dm_k(dm_k, device):
    """(spin, nk, n, n) complex128 density on `device` from an array, a
    tensor or a (re, im) pair; a missing spin axis is added."""
    if isinstance(dm_k, tuple):
        dm_k = torch.complex(as_f64(dm_k[0], device), as_f64(dm_k[1], device))
    elif isinstance(dm_k, torch.Tensor):
        dm_k = dm_k.to(device=device, dtype=torch.complex128)
    else:
        dm_k = torch.as_tensor(np.asarray(dm_k, dtype=complex), device=device)
    return dm_k[None] if dm_k.ndim == 3 else dm_k


def eri_R_to_eri_7d(eri_lo, ncells, nlo, device=torch.device("cuda")):
    """Translation-invariant supercell LO ERI -> the 7d k-resolved tensor
    eri_k[k1, k2, k3, p, q, r, s] = (k1 p, k2 q | k3 r, k4 s) with k4 =
    k1 - k2 + k3 implied by momentum conservation; Bloch convention
    |k p> = (1/sqrt(N)) sum_A e^{ikA} |A p>, 1D cyclic mesh (k4 is taken on
    the flattened index).  Four one-index transforms give every
    k-quadruple; the momentum-conserving ones are gathered.  Returns a
    complex128 tensor on `device`."""
    from libdmet_preview_tpu_torch.ops.eri_transform import _eri_R_to_k8
    device = torch.device(device)
    Ek = _eri_R_to_k8(eri_lo, ncells, nlo, device)
    Ek = Ek.permute(0, 2, 4, 6, 1, 3, 5, 7)        # [k1, k2, k3, k4, pqrs]
    k = torch.arange(ncells, device=device)
    k1, k2, k3 = k[:, None, None], k[None, :, None], k[None, None, :]
    return Ek[k1, k2, k3, (k1 - k2 + k3) % ncells]


def get_jk_from_eri_7d(eri_k, dm_k, device=torch.device("cuda")):
    """J/K per k-point from the 7d momentum-conserving k-ERI, with the
    repo's chemist conventions (vj = (pq|rs) D[rs], vk[p,s] = (pq|rs)
    D[rq]):

      J_k[pq] = sum_{k3 rs} (k p, k q | k3 r, k3 s) D_k3[rs]
      K_k[ps] = sum_{k2 qr} (k p, k2 q | k2 r, k s) D_k2[rq]

    dm_k: (spin, nk, n, n) complex Hermitian (per-spin blocks).
    Returns complex128 tensors (vj, vk) of the same shape on `device`."""
    device = torch.device(device)
    dm_k = _dm_k(dm_k, device)
    eri_k = torch.as_tensor(eri_k, device=device).to(torch.complex128)
    nk = dm_k.shape[1]
    diag = torch.arange(nk, device=device)
    # the ket legs of the density carry the conjugate Bloch phases
    dmc = dm_k.conj()
    # J: k1 = k2 = k (transfer 0); k4 = k3
    vj = torch.einsum("kmpqrs, tmrs -> tkpq", eri_k[diag, diag], dmc)
    # K: k3 = k2 (the density is k-diagonal); k4 = k1
    blk_k = eri_k[diag[:, None], diag[None, :], diag[None, :]]
    vk = torch.einsum("kmpqrs, tmrq -> tkps", blk_k, dmc)
    return vj, vk


def get_jk_from_gdf(factors, dm_k, device=torch.device("cuda")):
    """J/K per k from per-transfer GDF factors {q: (F_re, F_im)}
    (ops.eri_transform.make_gdf_factors), on `device`:

      M_q[(k1,p,a),(k3,s,r)] = (k1 p, k1+q a | k3+q r, k3 s)
                             = sum_x F_q[k1,p,a,x] conj(F_q[k3,s,r,x])

    J uses the q = 0 block; for K the k-diagonal density pairs
    (k p, k+q a | k+q r, k s), i.e. k3 = k within each transfer:

      J_k[pa] = sum_x F_0[k,p,a,x] sum_{k3 sr} conj(F_0[k3,s,r,x]) D_k3[rs]
      K_k[ps] = sum_q sum_{arx} F_q[k,p,a,x] conj(F_q[k,s,r,x]) D_{k+q}[ra]

    O(nk naux n^2) per transfer (no 7d tensor); the K build is one batched
    einsum over the transfers of equal rank.  k + q is taken on the
    flattened k index: a 1D cyclic mesh.  Returns complex128 tensors (vj,
    vk) of shape (spin, nk, n, n)."""
    from libdmet_preview_tpu_torch.ops.eri_transform import _cplx, _q_groups
    device = torch.device(device)
    dm_k = _dm_k(dm_k, device)
    nk = dm_k.shape[1]
    F0 = _cplx(factors[0], device)
    dmc = dm_k.conj()
    w = torch.einsum("msrx, tmrs -> tx", F0.conj(), dmc)
    vj = torch.einsum("kpax, tx -> tkpa", F0, w)
    vk = torch.zeros_like(vj)
    k = torch.arange(nk, device=device)
    for qs, _, F in _q_groups(factors, [(q, 1.0) for q in factors], device):
        qv = torch.as_tensor(qs, device=device)
        dmq = dmc[:, (k[None, :] + qv[:, None]) % nk]    # (t, q, k, r, a)
        g = torch.einsum("qkpax, tqkra -> tqkprx", F, dmq)
        vk += torch.einsum("tqkprx, qksrx -> tkps", g, F.conj())
    return vj, vk


def get_jk_ghf(eri_blocks, dm_so, device=torch.device("cuda")):
    """Generalized (GHF) J and K on a 2n x 2n generalized density from
    spin-blocked chemist ERIs (g_aa, g_bb, g_ab), on `device`: the Coulomb
    is spin-diagonal; the exchange acts on every sector, the off-diagonal
    spin blocks included:

      K_ab[p,s] = sum_{l k} (p_a l_a | k_b s_b) D[k_b, l_a].

    Arrays or tensors in; returns the (vj, vk) tensors (2n, 2n)."""
    device = torch.device(device)
    g_aa, g_bb, g_ab = (as_f64(x, device) for x in eri_blocks)
    dm = as_f64(dm_so, device)
    n = g_aa.shape[0]
    daa, dba, dbb = dm[:n, :n], dm[n:, :n], dm[n:, n:]
    vj = torch.zeros_like(dm)
    vj[:n, :n] = torch.einsum("pqrs, rs -> pq", g_aa, daa) \
        + torch.einsum("pqrs, rs -> pq", g_ab, dbb)
    vj[n:, n:] = torch.einsum("pqrs, rs -> pq", g_bb, dbb) \
        + torch.einsum("rspq, rs -> pq", g_ab, daa)
    vk = torch.zeros_like(dm)
    vk[:n, :n] = torch.einsum("pqrs, rq -> ps", g_aa, daa)
    vk[n:, n:] = torch.einsum("pqrs, rq -> ps", g_bb, dbb)
    vk[:n, n:] = torch.einsum("plks, kl -> ps", g_ab, dba)
    vk[n:, :n] = vk[:n, n:].T          # Hermitian D -> Hermitian K
    return vj, vk


def eri_to_gdf(eri_lo, ncells, nlo, tol=1e-10, device=torch.device("cuda")):
    """Convert a translation-invariant supercell ERI into per-transfer
    GDF factors: delegates to make_gdf_factors."""
    from libdmet_preview_tpu_torch.ops.eri_transform import make_gdf_factors
    return make_gdf_factors(eri_lo, ncells, nlo, tol=tol, device=device)
