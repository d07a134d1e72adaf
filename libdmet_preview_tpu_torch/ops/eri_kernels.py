"""
Density-fitting embedding-ERI syrk (PyTorch port of
libdmet_preview_tpu/ops/pallas_eri.py: syrk_df for F2=None, pack_tril,
unpack_s4, eri_from_df).

  eri[pq, rs] = sum_x F[x, pq] F[x, rs],   F = s4 pack of B^T L_x B

On a CUDA tensor syrk_df launches the hand-written Hopper kernel
(csrc/syrk_df.cu), exact in float64; on a CPU tensor it runs the plain
version syrk_df_plain.  There is no fallback between the two.
"""

import ctypes

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops import _build


def syrk_df_plain(F):
    """Plain PyTorch version of the syrk: F^T F."""
    return F.T @ F


def syrk_df(F):
    """Symmetric s4-packed DF-ERI F^T F of F (naux, npair) float64.

    CPU tensor: syrk_df_plain.  CUDA tensor: the hand kernel, which
    raises on a refused launch.  syrk_df.launches counts kernel launches."""
    if F.device.type == "cpu":
        return syrk_df_plain(F)
    if F.device.type != "cuda":
        raise ValueError("syrk_df: unsupported device %s" % F.device)
    if F.dtype != torch.float64 or F.dim() != 2:
        raise ValueError("syrk_df: need a 2-D float64 tensor, got %s %s"
                         % (F.dtype, tuple(F.shape)))
    if not F.is_contiguous():
        raise ValueError("syrk_df: F must be contiguous")
    naux, npair = F.shape
    if naux == 0 or npair == 0 or npair > 2 ** 31 - 1 or naux > 2 ** 31 - 1:
        raise ValueError("syrk_df: unsupported shape %s" % (tuple(F.shape),))
    fn = _build.load("syrk_df")
    out = torch.empty((npair, npair), dtype=F.dtype, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        rc = fn(ctypes.c_void_p(F.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                int(naux), int(npair), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("syrk_df kernel launch failed: cudaError %d" % rc)
    syrk_df.launches += 1
    return out


syrk_df.launches = 0


def tril_pairs(neo, device):
    """np.tril_indices(neo) row order as two long tensors on `device`."""
    ti, tj = np.tril_indices(neo)
    return (torch.as_tensor(ti, device=device),
            torch.as_tensor(tj, device=device))


def pack_tril(Lemb):
    """(naux, neo, neo) symmetric -> s4-packed (naux, neo*(neo+1)/2)."""
    ti, tj = tril_pairs(Lemb.shape[-1], Lemb.device)
    return Lemb[:, ti, tj]


def unpack_s4(eri_s4, neo):
    """s4-packed (npair, npair) -> full (neo, neo, neo, neo)."""
    ti, tj = tril_pairs(neo, eri_s4.device)
    npair = ti.shape[0]
    M = torch.zeros((neo, neo, npair), dtype=eri_s4.dtype,
                    device=eri_s4.device)
    M[ti, tj] = eri_s4[:npair, :npair]
    M[tj, ti] = eri_s4[:npair, :npair]
    out = torch.zeros((neo, neo, neo, neo), dtype=eri_s4.dtype,
                      device=eri_s4.device)
    out[:, :, ti, tj] = M
    out[:, :, tj, ti] = M
    return out


def eri_from_df(Lemb):
    """Full embedding ERI (neo, neo, neo, neo) from embedded DF factors
    Lemb (naux, neo, neo): pack, syrk_df, unpack."""
    return unpack_s4(syrk_df(pack_tril(Lemb)), Lemb.shape[-1])
