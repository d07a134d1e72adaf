"""
Embedding-Hamiltonian container (PyTorch port of
libdmet_preview_tpu/models/integral.py: Integral, get_eri_format,
restore_eri; the FCIDUMP/HDF5 I/O is still to port).

Integral is a plain container:
  H0: scalar
  H1: {"cd": (spin, n, n)}            spin = 1 (restricted) or 2
  H2: {"ccdd": (spin_pair, ...)}      spin_pair = 1 or 3, order [aa, bb, ab]
  ovlp: (n, n) or (spin, n, n) or None
The blocks are NumPy arrays or torch tensors; the port's embedding
Hamiltonian keeps them as tensors on the device that built them.
get_eri_format / restore_eri are host NumPy.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


class Integral(object):
    def __init__(self, norb, restricted, bogoliubov, H0, H1, H2, ovlp=None):
        self.norb = norb
        self.restricted = restricted
        self.bogoliubov = bogoliubov
        self.H0 = H0
        log.eassert(H1 is not None and H2 is not None,
                    "H1 and H2 cannot be None")
        # arrays or tensors, kept as given: the embedding Hamiltonian's
        # blocks stay on the device that built them
        self.H1 = dict(H1)
        self.H2 = dict(H2)
        self.ovlp = ovlp

    def copy(self):
        import copy as _copy
        return _copy.deepcopy(self)

    def __str__(self):
        return ("Integral(norb=%d, restricted=%s, bogoliubov=%s)"
                % (self.norb, self.restricted, self.bogoliubov))


def get_eri_format(eri, norb):
    """Detect ERI symmetry format: s1 / s4 / s8 and spin dimension
    (reference integral.py:883-930)."""
    eri = np.asarray(eri)
    npair = norb * (norb + 1) // 2
    if eri.ndim == 4:
        return "s1", 0
    if eri.ndim == 2:
        if eri.shape == (npair, npair):
            return "s4", 0
        elif eri.ndim == 2 and eri.size == npair * (npair + 1) // 2:
            return "s8", 0
    if eri.ndim == 5:
        return "s1", eri.shape[0]
    if eri.ndim == 3:
        if eri.shape[-2:] == (npair, npair):
            return "s4", eri.shape[0]
        else:
            return "s8", eri.shape[0]
    if eri.ndim == 1:
        return "s8", 0
    raise ValueError("cannot detect eri format for shape %s" % str(eri.shape))


def restore_eri(eri, norb, symmetry=1):
    """Convert ERI between s1/s4/s8 storage (minimal ao2mo.restore clone)."""
    eri = np.asarray(eri)
    fmt, spin = get_eri_format(eri, norb)
    if spin:
        return np.asarray([restore_eri(e, norb, symmetry) for e in eri])
    npair = norb * (norb + 1) // 2
    tril = np.tril_indices(norb)
    if fmt == "s8" and symmetry == 8:
        return eri
    if fmt == "s8":
        # unpack to s4 first
        s4 = np.zeros((npair, npair))
        tp = np.tril_indices(npair)
        s4[tp] = eri
        s4 = s4 + s4.T - np.diag(np.diag(s4))
        eri, fmt = s4, "s4"
    if fmt == "s4" and symmetry == 1:
        full = np.zeros((norb,) * 4)
        tmp = np.zeros((norb, norb, npair))
        tmp[tril[0], tril[1]] = eri
        tmp[tril[1], tril[0]] = eri
        full_flat = tmp  # (i, j, kl-pair)
        full[:, :, tril[0], tril[1]] = full_flat
        full[:, :, tril[1], tril[0]] = full_flat
        return full
    if fmt == "s1" and symmetry == 4:
        return eri[:, :, tril[0], tril[1]][tril[0], tril[1]]
    if fmt == "s1" and symmetry == 1:
        return eri
    if fmt == "s4" and symmetry == 4:
        return eri
    if fmt == "s1" and symmetry == 8:
        s4 = restore_eri(eri, norb, 4)
        tp = np.tril_indices(npair)
        return s4[tp]
    if fmt == "s4" and symmetry == 8:
        tp = np.tril_indices(npair)
        return eri[tp]
    raise NotImplementedError("restore %s -> s%d" % (fmt, symmetry))
