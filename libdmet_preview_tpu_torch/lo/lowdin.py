"""
Lowdin orthogonalization utilities (PyTorch port of
libdmet_preview_tpu/lo/lowdin.py).

Every function computes on the device of its first tensor argument; an
array goes to `device` (default CUDA), and the other arguments follow the
first.  The k-resolved helpers keep the JAX package's (re, im) pair I/O
and work on complex128 inside.
"""

import torch

from libdmet_preview_tpu_torch.utils.misc import as_tensor


def _h(A):
    return A.conj().transpose(-2, -1)


def lowdin_orth(S, tol=1e-12, device=torch.device("cuda")):
    """S^{-1/2} (symmetric orthogonalization matrix)."""
    S = as_tensor(S, device)
    w, v = torch.linalg.eigh(S)
    wmin = float(w.min())
    if wmin < tol:
        raise ValueError("overlap matrix nearly singular: min eig %g" % wmin)
    return (v / torch.sqrt(w).to(v.dtype)) @ _h(v)


def vec_lowdin(C, S=None, device=torch.device("cuda")):
    """Lowdin-orthonormalize the columns of C in metric S."""
    C = as_tensor(C, device)
    M = _h(C) @ C if S is None else _h(C) @ as_tensor(S, C.device) @ C
    return C @ lowdin_orth(M)


def check_orthonormal(C, S=None, tol=1e-10, device=torch.device("cuda")):
    C = as_tensor(C, device)
    M = _h(C) @ C if S is None else _h(C) @ as_tensor(S, C.device) @ C
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return bool(torch.max(torch.abs(M - eye)) < tol)


def symmetrize_lo_kpair(C_re, C_im, neg_map, device=torch.device("cuda")):
    """Enforce time-reversal symmetry C(-k) = C(k)* on a k-resolved LO
    coefficient pair: average each k with the conjugate of its -k partner
    (neg_map[k] = index of -k).  Returns a new (re, im) pair."""
    C_re = as_tensor(C_re, device)
    C_im = as_tensor(C_im, C_re.device)
    neg = torch.as_tensor(neg_map, device=C_re.device, dtype=torch.long)
    return 0.5 * (C_re + C_re[neg]), 0.5 * (C_im - C_im[neg])


def check_lo_time_reversal(C_re, C_im, neg_map, tol=1e-9,
                           device=torch.device("cuda")):
    """Max violation of C(-k) = C(k)* (0 for a symmetrized set)."""
    C_re = as_tensor(C_re, device)
    C_im = as_tensor(C_im, C_re.device)
    neg = torch.as_tensor(neg_map, device=C_re.device, dtype=torch.long)
    return max(float(torch.abs(C_re - C_re[neg]).max()),
               float(torch.abs(C_im + C_im[neg]).max()))


def make_real_columns(C_re, C_im, tol=1e-9, device=torch.device("cuda")):
    """Fix the column phase gauge so complex orbitals become real when a
    real gauge exists: for c = e^{i theta} r with r real, sum_j c_j^2 =
    e^{2 i theta} |r|^2, so theta is half the phase of the column's plain
    self-product.  Returns (C_re', C_im', ok), ok a per-column bool tensor
    marking columns that became real to tol."""
    C_re = as_tensor(C_re, device).to(torch.float64)
    C_im = as_tensor(C_im, C_re.device).to(torch.float64)
    C = torch.complex(C_re, C_im)
    z2 = torch.sum(C * C, dim=-2)
    ph = torch.exp(-0.5j * torch.angle(z2))
    C = C * ph[..., None, :]
    ok = torch.abs(C.imag).amax(dim=-2) < tol
    return C.real.contiguous(), C.imag.contiguous(), ok
