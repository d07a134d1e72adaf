"""
Host index helpers (the two of libdmet_preview_tpu/utils/misc.py that the
fused lattice iteration needs, without its jax.numpy import).
"""

import numpy as np

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
