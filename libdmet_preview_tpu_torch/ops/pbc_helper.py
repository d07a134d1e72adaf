"""
J and K matrices for lattice Hamiltonians with a local two-body term
(PyTorch port of get_jk_local of libdmet_preview_tpu/ops/pbc_helper.py;
the 'nearest', k-resolved and GDF versions are still to port).
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import as_f64


def _jk_local(eri, dm):
    vj = torch.einsum("ijkl, skl -> sij", eri, dm)
    vk = torch.einsum("ilkj, skl -> sij", eri, dm)
    return vj, vk


def get_jk_local(eri, dm0, device):
    """J/K from a local (single-cell) ERI and the cell-averaged density
    rho(R=0), contracted on `device`.  Both are k-independent.

    dm0: (spin, nao, nao) real.  Returns host (vj, vk) with shape
    (spin, nao, nao), like the lattice operators they update."""
    dm0 = np.asarray(dm0)
    if dm0.ndim == 2:
        dm0 = dm0[None]
    vj, vk = _jk_local(as_f64(eri, device), as_f64(dm0, device))
    return vj.cpu().numpy(), vk.cpu().numpy()
