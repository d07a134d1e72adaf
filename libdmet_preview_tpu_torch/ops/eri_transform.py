"""
Embedding-ERI transforms from Cholesky / density-fitting factors (PyTorch
port of libdmet_preview_tpu/ops/eri_transform.py: cholesky_eri,
_rotate_chol, get_emb_eri_chol, get_emb_eri_mol).

    L_emb[x, i, j] = C[p, i] L[x, p, q] C[q, j]       (LO -> EO rotation)
    eri[s]         = sum_x La[x, ij] Lb[x, kl]         (DF syrk)

The rotation is two batched f64 GEMMs (torch.matmul).  Each spin's factors
are s4-packed once; the syrk is eri_kernels.syrk_df: on CUDA tensors the
hand-written Hopper kernels (the symmetric one for the aa and bb blocks,
the cross one for ab), on CPU tensors their plain versions.  Each piece is
a utils.timer stage.  The JAX package's size rule for
choosing its Pallas kernel and its HDF5 `outcore` mode are not ported.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.ops.eri_kernels import (pack_tril, syrk_df,
                                                       unpack_s4)


def cholesky_eri(eri, tol=1e-9, max_rank=None):
    """Pivoted (modified) Cholesky factorization of a (n, n, n, n) chemist
    ERI: eri ~= sum_x L[x] (x) L[x], L (naux, n, n).  Host NumPy."""
    eri = np.asarray(eri)
    n = eri.shape[0]
    M = eri.reshape(n * n, n * n).copy()
    diag = np.diag(M).copy()
    if max_rank is None:
        max_rank = n * n
    Ls = []
    for _ in range(max_rank):
        p = int(np.argmax(diag))
        dmax = diag[p]
        if dmax < tol:
            break
        l = M[:, p] / np.sqrt(dmax)
        Ls.append(l)
        M -= np.outer(l, l)
        diag = np.maximum(np.diag(M), 0.0)
    L = np.asarray(Ls).reshape(len(Ls), n, n)
    # symmetrize (pq) since eri has (pq|rs) = (qp|rs) for real orbitals
    return 0.5 * (L + L.transpose(0, 2, 1))


def _rotate_chol(L, C):
    """(naux, n, n) x (n, neo) -> (naux, neo, neo): C^T L_x C as two
    batched GEMMs."""
    return torch.matmul(C.T, torch.matmul(L, C))


def _flat_basis(L, basis):
    """(spin, ncells, nlo, neo) basis -> (spin, nsites, neo) tensor on L's
    device."""
    basis = as_f64(basis, L.device)
    spin, ncells, nlo, neo = basis.shape
    return basis.reshape(spin, ncells * nlo, neo)


def get_emb_eri_chol(L, basis):
    """Embedding ERI from Cholesky/DF factors.

    L: (naux, nsites, nsites) float64 tensor in the (LO, full-lattice)
    site basis; basis: (spin, ncells, nlo, neo) embedding basis (R
    stripe), tensor or array.  Returns the (spin_pair, neo, neo, neo, neo)
    tensor on L's device with blocks [aa] or [aa, bb, ab] (chemist),
    matching embham._emb_H2's contract."""
    C = _flat_basis(L, basis)
    spin, _, neo = C.shape
    dev = L.device
    with stage("ERI rotation", dev):
        Ls = [_rotate_chol(L, C[s]) for s in range(spin)]
    with stage("ERI pack", dev):
        Fs = [pack_tril(Lemb) for Lemb in Ls]
    del Ls
    pairs = [(0, None)] if spin == 1 else [(0, None), (1, None), (0, 1)]
    out = torch.empty((len(pairs),) + (neo,) * 4, dtype=L.dtype, device=dev)
    for m, (s1, s2) in enumerate(pairs):
        name = "syrk (tri kernel)" if s2 is None else "syrk ab (cross kernel)"
        with stage(name, dev):
            s4 = syrk_df(Fs[s1], None if s2 is None else Fs[s2])
        with stage("ERI unpack", dev):
            unpack_s4(s4, neo, out=out[m])
    return out


def get_emb_eri_mol(eri_full, basis):
    """Direct (un-factorized) embedding transform of a dense (n,)*4 ERI
    tensor; brute-force oracle for get_emb_eri_chol."""
    g = eri_full
    C = _flat_basis(g, basis)

    def t4(Cp, Cq):
        return torch.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, Cp, Cp, Cq, Cq)

    if C.shape[0] == 1:
        return t4(C[0], C[0])[None]
    return torch.stack([t4(C[0], C[0]), t4(C[1], C[1]), t4(C[0], C[1])])
