"""
Small helpers (PyTorch port of libdmet_preview_tpu/utils/misc.py; the
TPU workaround add_spin_dim_jnp is not ported).  The index bookkeeping is
host NumPy; pack_tril / unpack_tril take arrays or tensors and return the
same kind.
"""

import functools

import numpy as np
import torch

Iterable = (list, tuple, np.ndarray)


def keyword_aliases(**old_to_new):
    """Decorator: the keyword `old` is taken as the parameter `new`, for
    parameters that carry the JAX package's name and had another one in
    the port before (the old keyword keeps working)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            for old, new in old_to_new.items():
                if old in kwargs:
                    if new in kwargs:
                        raise TypeError("%s() got both %s= and %s="
                                        % (fn.__name__, old, new))
                    kwargs[new] = kwargs.pop(old)
            return fn(*args, **kwargs)
        return call
    return wrap


def max_abs(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.size == 0:
        return 0.0
    if np.iscomplexobj(x):
        return float(np.abs(x).max())
    return float(max(np.max(x), -np.min(x)))


def mdot(*args):
    """Chained matrix product (arrays or tensors)."""
    r = args[0]
    for a in args[1:]:
        r = r @ a
    return r


def tril_indices(n):
    return np.tril_indices(n)


def tril_diag_indices(n):
    """Indices of the diagonal elements within a packed-tril vector of size
    n(n+1)/2."""
    return np.cumsum(np.arange(1, n + 1)) - 1


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


def as_tensor(x, device):
    """x as a tensor: a tensor is returned as it is (its device and
    dtype); anything else goes to `device` with its NumPy dtype (a
    read-only array is copied)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.require(x, requirements=["W"]), device=device)


def to_host(x):
    """A NumPy array of a tensor (detached, copied to the host) or of an
    array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_blas_threads():
    """Context manager: the host BLAS (NumPy / SciPy) inside the block uses
    at most the intra-op threads PyTorch has been given
    (torch.get_num_threads()), as the port's own host loops do; a no-op
    where threadpoolctl is not installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        import contextlib
        return contextlib.nullcontext()
    return threadpool_limits(torch.get_num_threads(), user_api="blas")


def pack_tril(A):
    """Pack the lower triangle of the last two axes (row-major tril order)."""
    if isinstance(A, torch.Tensor):
        n = A.shape[-1]
        i, j = torch.tril_indices(n, n, device=A.device)
        return A[..., i, j]
    A = np.asarray(A)
    idx = np.tril_indices(A.shape[-1])
    return A[..., idx[0], idx[1]]


def unpack_tril(Ap, n=None):
    """Inverse of pack_tril: a symmetric matrix from its packed triangle."""
    npair = Ap.shape[-1]
    if n is None:
        n = int(round((np.sqrt(8 * npair + 1) - 1) / 2))
    if isinstance(Ap, torch.Tensor):
        i, j = torch.tril_indices(n, n, device=Ap.device)
        out = Ap.new_zeros(Ap.shape[:-1] + (n, n))
        out[..., i, j] = Ap
        out[..., j, i] = Ap
        return out
    Ap = np.asarray(Ap)
    i, j = np.tril_indices(n)
    out = np.zeros(Ap.shape[:-1] + (n, n), dtype=Ap.dtype)
    out[..., i, j] = Ap
    out[..., j, i] = Ap
    return out


def format_idx(idx_list):
    return ", ".join(map(str, idx_list))
