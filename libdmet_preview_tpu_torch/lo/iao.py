"""
Intrinsic atomic orbitals (Knizia, JCTC 9, 4834 (2013)); PyTorch port of
libdmet_preview_tpu/lo/iao.py.

Given occupied MOs in a large basis B1 and a minimal reference basis B2:

    P12 = S1^-1 S12,   C~ = orth( S1^-1 S12 S2^-1 S21 C )
    A   = (CC'S1) (C~C~'S1) P12 + (1 - CC'S1)(1 - C~C~'S1) P12

Lowdin-orthonormalized in the S1 metric.  The virtual complement (PAOs)
spans the remainder of B1 after projecting out the IAOs.  The inverses
of the JAX package are Cholesky solves here, on the device of S1 (an
array goes to `device`, default CUDA; the other arguments follow S1).
"""

import torch

from libdmet_preview_tpu_torch.lo.lowdin import vec_lowdin
from libdmet_preview_tpu_torch.utils.misc import as_tensor


def _chol_solve(S, B):
    """S^-1 B for a symmetric positive-definite S."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(S))


def get_iao(S1, S12, S2, C_occ, device=torch.device("cuda")):
    """IAO coefficients (nao1, n_minimal) in basis B1, S1-orthonormal."""
    S1 = as_tensor(S1, device)
    S12, S2, C = (as_tensor(x, S1.device) for x in (S12, S2, C_occ))
    P12 = _chol_solve(S1, S12)
    # project occupied MOs into the minimal space and back, re-orthonormal
    Ct = vec_lowdin(P12 @ _chol_solve(S2, S12.T @ C), S1)
    eye = torch.eye(S1.shape[0], dtype=S1.dtype, device=S1.device)
    PC = C @ (C.T @ S1)
    PCt = Ct @ (Ct.T @ S1)
    A = PC @ PCt @ P12 + (eye - PC) @ (eye - PCt) @ P12
    return vec_lowdin(A, S1)


def get_iao_virt(S1, C_iao, virt_ao_idx=None, tol=1e-8,
                 device=torch.device("cuda")):
    """Complementary virtual orbitals (PAOs): project the IAOs out of
    selected AOs and Lowdin-orthonormalize.

    virt_ao_idx: AOs to project (the shells absent from the minimal
    reference basis) -- keeps the PAOs atom-attached and, on a ring,
    translationally equivariant.  Defaults to an eigenbasis of the full
    complement."""
    S1 = as_tensor(S1, device)
    C_iao = as_tensor(C_iao, S1.device)
    nao, niao = S1.shape[0], C_iao.shape[1]
    P = torch.eye(nao, dtype=S1.dtype, device=S1.device) \
        - C_iao @ (C_iao.T @ S1)
    if virt_ao_idx is not None:
        idx = torch.as_tensor(list(virt_ao_idx), dtype=torch.long,
                              device=S1.device)
        return vec_lowdin(P[:, idx], S1)
    w, v = torch.linalg.eigh(P.T @ S1 @ P)
    keep = w > tol
    C_virt = P @ v[:, keep] / torch.sqrt(w[keep])
    assert C_virt.shape[1] == nao - niao
    return C_virt
