"""
Density-fitting embedding-ERI syrk (PyTorch port of
libdmet_preview_tpu/ops/pallas_eri.py: syrk_df, pack_tril, unpack_s4,
eri_from_df_pallas).

  eri[pq, rs] = sum_x F[x, pq] F2[x, rs],   F = s4 pack of B^T L_x B

F2 = None is the symmetric syrk F^T F (restricted, or the aa / bb blocks);
a distinct F2 is the unrestricted ab cross block.  On CUDA tensors syrk_df
launches the hand-written Hopper kernels of csrc/syrk_df.cu, exact in
float64; on CPU tensors it runs the plain version syrk_df_plain.  There is
no fallback between the two.
"""

import ctypes

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops import _build


def syrk_df_plain(F, F2=None):
    """Plain PyTorch version of the syrk: F^T F, or F^T F2."""
    return F.T @ (F if F2 is None else F2)


def _check_operand(F, name):
    if F.dtype != torch.float64 or F.dim() != 2:
        raise ValueError("syrk_df: %s must be a 2-D float64 tensor, got %s %s"
                         % (name, F.dtype, tuple(F.shape)))
    if not F.is_contiguous():
        raise ValueError("syrk_df: %s must be contiguous" % name)


def syrk_df(F, F2=None):
    """s4-packed DF-ERI F^T F (F2=None, exactly symmetric) or F^T F2 of
    (naux, npair) float64 operands.

    CPU tensors: syrk_df_plain.  CUDA tensors: the hand kernel, which
    raises on a refused launch.  syrk_df.launches counts launches of the
    symmetric kernel, syrk_df.cross_launches those of the cross kernel."""
    if F2 is not None and (F2.device != F.device or F2.shape != F.shape):
        raise ValueError("syrk_df: F %s on %s and F2 %s on %s differ"
                         % (tuple(F.shape), F.device, tuple(F2.shape),
                            F2.device))
    if F.device.type == "cpu":
        return syrk_df_plain(F, F2)
    if F.device.type != "cuda":
        raise ValueError("syrk_df: unsupported device %s" % F.device)
    _check_operand(F, "F")
    if F2 is not None:
        _check_operand(F2, "F2")
    naux, npair = F.shape
    # the cross kernel's grid is (npair/64)^2 with a y extent <= 65535
    if naux == 0 or npair == 0 or naux > 2 ** 31 - 1 \
            or npair > 65535 * 64:
        raise ValueError("syrk_df: unsupported shape %s" % (tuple(F.shape),))
    out = torch.empty((npair, npair), dtype=F.dtype, device=F.device)
    with torch.cuda.device(F.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(F.device).cuda_stream)
        if F2 is None:
            fn = _build.load("syrk_df", "syrk_df_tri_f64")
            rc = fn(ctypes.c_void_p(F.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()),
                    int(naux), int(npair), stream)
        else:
            fn = _build.load("syrk_df", "syrk_df_cross_f64")
            rc = fn(ctypes.c_void_p(F.data_ptr()),
                    ctypes.c_void_p(F2.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()),
                    int(naux), int(npair), stream)
    if rc != 0:
        raise RuntimeError("syrk_df kernel launch failed: cudaError %d" % rc)
    if F2 is None:
        syrk_df.launches += 1
    else:
        syrk_df.cross_launches += 1
    return out


syrk_df.launches = 0
syrk_df.cross_launches = 0


def tril_pairs(neo, device):
    """np.tril_indices(neo) row order as two long tensors on `device`."""
    ti, tj = np.tril_indices(neo)
    return (torch.as_tensor(ti, device=device),
            torch.as_tensor(tj, device=device))


def pack_tril(Lemb):
    """(naux, neo, neo) symmetric -> s4-packed (naux, neo*(neo+1)/2)."""
    ti, tj = tril_pairs(Lemb.shape[-1], Lemb.device)
    return Lemb[:, ti, tj]


def unpack_s4(eri_s4, neo, out=None):
    """s4-packed (npair, npair) -> full (neo, neo, neo, neo), written into
    `out` when given.  The s4 matrix need not be symmetric (the ab block):
    rows index the (ij) pair, columns the (kl) pair."""
    ti, tj = tril_pairs(neo, eri_s4.device)
    npair = ti.shape[0]
    M = torch.zeros((neo, neo, npair), dtype=eri_s4.dtype,
                    device=eri_s4.device)
    M[ti, tj] = eri_s4[:npair, :npair]
    M[tj, ti] = eri_s4[:npair, :npair]
    if out is None:
        out = torch.empty((neo, neo, neo, neo), dtype=eri_s4.dtype,
                          device=eri_s4.device)
    out[:, :, ti, tj] = M
    out[:, :, tj, ti] = M
    return out


def eri_from_df(Lemb, Lemb2=None, out=None):
    """Full embedding ERI (neo, neo, neo, neo) from embedded DF factors
    Lemb (naux, neo, neo): pack, syrk_df, unpack.  With Lemb2 the cross
    block eri[ij, kl] = sum_x Lemb[x, ij] Lemb2[x, kl] (the unrestricted
    ab channel)."""
    F2 = None if Lemb2 is None else pack_tril(Lemb2)
    return unpack_s4(syrk_df(pack_tril(Lemb), F2), Lemb.shape[-1], out=out)
