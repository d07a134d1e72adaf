"""
Host helpers (the ones of libdmet_preview_tpu/utils/misc.py that the port
needs, without its jax.numpy import).
"""

import numpy as np
import torch

Iterable = (list, tuple, np.ndarray)


def triu_diag_indices(n):
    """Indices of diagonal elements in combinations_with_replacement(range(n), 2) order."""
    # pairs (i, j) with i <= j, row-major: index of (i, i)
    idx = []
    k = 0
    for i in range(n):
        idx.append(k)
        k += n - i
    return np.asarray(idx)


def add_spin_dim(H, spin, non_spin_dim=3):
    """Ensure H has a leading spin axis of length `spin` (broadcasting if 1)."""
    H = np.asarray(H)
    if H.ndim == non_spin_dim:
        H = H[None]
    assert H.ndim == non_spin_dim + 1
    if H.shape[0] < spin:
        H = np.asarray([H[0]] * spin)
    return H


def as_f64(x, device):
    """Array or tensor x as a float64 tensor on `device` (no copy when it
    already is one there; a read-only array is copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.require(x, np.float64, ["C", "W"]),
                           device=device)
