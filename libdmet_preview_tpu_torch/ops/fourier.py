"""
k <-> R transforms for stripe lattice operators (PyTorch port of
libdmet_preview_tpu/ops/fourier.py, R2k/k2R only).

The lattice operators are transformed once per lattice set-up on the host,
as NumPy DFT-by-table on the (small) cell mesh; a torch tensor (the
embedding basis) is transformed on its own device with the same tables.
k-space results are (re, im) pairs, as in the JAX package.

Conventions (match the JAX package):
  R2k: A(k) = sum_R e^{-i k.R} A(R)
  k2R: A(R) = (1/Nk) sum_k e^{+i k.R} A(k)
The cell / k axis is the -3rd axis; leading axes (spin) are batch axes.
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables


def _is_tensor(A):
    return isinstance(A[0] if isinstance(A, tuple) else A, torch.Tensor)


def _pair_t(A):
    if isinstance(A, tuple):
        return A
    return A, torch.zeros_like(A)


def _tables_t(kmesh, like):
    cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
    return (torch.as_tensor(cos_t, dtype=like.dtype, device=like.device),
            torch.as_tensor(sin_t, dtype=like.dtype, device=like.device))


def _pair(A):
    if isinstance(A, tuple):
        return np.asarray(A[0], dtype=float), np.asarray(A[1], dtype=float)
    A_re = np.asarray(A, dtype=float)
    return A_re, np.zeros_like(A_re)


def R2k(A, kmesh):
    """Stripe R -> k.  A: ((spin,) ncells, n, m) real array or tensor, or
    an (re, im) pair of them.  Returns the (re, im) pair, tensors on A's
    device for tensor input."""
    if _is_tensor(A):
        A_re, A_im = _pair_t(A)
        cos_t, sin_t = _tables_t(kmesh, A_re)
        ein = torch.einsum
    else:
        A_re, A_im = _pair(A)
        cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
        ein = np.einsum
    re = (ein("kR, ...Rij -> ...kij", cos_t, A_re)
          + ein("kR, ...Rij -> ...kij", sin_t, A_im))
    im = (ein("kR, ...Rij -> ...kij", cos_t, A_im)
          - ein("kR, ...Rij -> ...kij", sin_t, A_re))
    return re, im


def k2R(A, kmesh, real=True):
    """k -> stripe R.  A is a (re, im) pair (or real array); returns the
    real stripe if real=True, else the (re, im) pair."""
    cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
    nk = cos_t.shape[0]
    A_re, A_im = _pair(A)
    re = (np.einsum("kR, ...kij -> ...Rij", cos_t, A_re)
          - np.einsum("kR, ...kij -> ...Rij", sin_t, A_im)) / nk
    if real:
        return re
    im = (np.einsum("kR, ...kij -> ...Rij", cos_t, A_im)
          + np.einsum("kR, ...kij -> ...Rij", sin_t, A_re)) / nk
    return re, im
