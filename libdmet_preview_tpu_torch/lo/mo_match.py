"""
MO matching and rotation for solver restart (PyTorch port of
libdmet_preview_tpu/lo/mo_match.py).

Given two MO sets, find the orthogonal rotation of the second that best
matches the first (orthogonal Procrustes via SVD of the overlap) so that
amplitude/CI restart files stay usable across DMET iterations.  A leading
spin axis is a batch axis of one batched product / SVD.  Each function
computes on the device of its first argument (an array goes to `device`,
default CUDA; the other arguments follow it).
"""

import torch

from libdmet_preview_tpu_torch.lo.lowdin import _h
from libdmet_preview_tpu_torch.utils.misc import as_tensor


def get_mo_ovlp(mo1, mo2, ovlp=None, device=torch.device("cuda")):
    """<mo1 | mo2> overlap matrix; per-spin if a leading spin dim exists."""
    mo1 = as_tensor(mo1, device)
    mo2 = as_tensor(mo2, mo1.device)
    if ovlp is None:
        return _h(mo1) @ mo2
    return _h(mo1) @ as_tensor(ovlp, mo1.device) @ mo2


def trans_mo(mo, u, device=torch.device("cuda")):
    """Rotate MOs by u (per spin if batched)."""
    mo = as_tensor(mo, device)
    return mo @ as_tensor(u, mo.device)


def find_closest_mo(mo_new, mo_ref, ovlp=None, return_rotmat=False,
                    device=torch.device("cuda")):
    """Rotate mo_new to maximize overlap with mo_ref (orthogonal
    Procrustes): u = V W^T from SVD of <mo_new | mo_ref>.  Returns the
    rotated MOs (and the rotation if requested)."""
    mo_new = as_tensor(mo_new, device)
    S = get_mo_ovlp(mo_new, mo_ref, ovlp)
    v, _, wt = torch.linalg.svd(S)
    u = v @ wt
    mo_rot = mo_new @ u
    if return_rotmat:
        return mo_rot, u
    return mo_rot
