"""
Correlation-potential (vcor) parametrizations (PyTorch port of
libdmet_preview_tpu/ops/vcor.py, Vcor and VcorLocal).

One Vcor class driven by static index/coefficient tables:

    V[s, i, j] = sum_e coeff[e] * param[pidx[e]]  over entries e with
                 (s, i, j) = (sidx[e], iidx[e], jidx[e])

The tables are host NumPy built once; the fused iteration moves the dense
gradient tensor to its device.
"""

import itertools as it
import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import triu_diag_indices


class Vcor(object):
    """Parametrized local potential: param vector <-> (spin_comp, nao, nao)."""

    def __init__(self, nparam, spin_comp, nao, entries, diag_idx=None,
                 restricted=False, bogoliubov=False, idx_range=None):
        self.nparam = nparam
        self.spin_comp = spin_comp
        self.nao = nao
        self.restricted = restricted
        self.bogoliubov = bogoliubov
        self.idx_range = list(range(nao)) if idx_range is None else list(idx_range)
        self.local = True
        self.is_vcor_kpts = False
        self._diag_idx = diag_idx
        pidx, sidx, iidx, jidx, coeff = entries
        self._pidx = np.asarray(pidx, dtype=np.int32)
        self._sidx = np.asarray(sidx, dtype=np.int32)
        self._iidx = np.asarray(iidx, dtype=np.int32)
        self._jidx = np.asarray(jidx, dtype=np.int32)
        self._coef = np.asarray(coeff, dtype=np.float64)
        self._grad = None
        self.param = np.zeros(nparam)
        self.value = self.evaluate()

    def update(self, param):
        self.param = np.asarray(param, dtype=float).copy()
        self.value = self.evaluate()

    def get(self, i=0, kspace=True):
        if kspace or i == 0:
            return self.value
        return np.zeros_like(self.value)

    def islocal(self):
        return self.local

    is_local = islocal

    def length(self):
        return self.nparam

    def evaluate(self):
        V = np.zeros((self.spin_comp, self.nao, self.nao))
        np.add.at(V, (self._sidx, self._iidx, self._jidx),
                  self._coef * self.param[self._pidx])
        return V

    def gradient(self):
        """Dense dV/dparam, (nparam, spin_comp, nao, nao)."""
        if self._grad is None:
            g = np.zeros((self.nparam, self.spin_comp, self.nao, self.nao))
            np.add.at(g, (self._pidx, self._sidx, self._iidx, self._jidx),
                      self._coef)
            self._grad = g
        return self._grad

    def assign(self, v0):
        """Project a target matrix onto the parametrization."""
        v0 = np.asarray(v0, dtype=float)
        g = self.gradient()
        log.eassert(v0.shape == g.shape[1:],
                    "vcor assign: expected shape %s, got %s",
                    g.shape[1:], v0.shape)
        gnorm = np.einsum("aspq, aspq -> a", g, g)
        param = np.einsum("aspq, spq -> a", g, v0) / gnorm
        self.update(param)
        diff = np.abs(v0 - self.get()).max()
        if diff > 1e-7:
            log.warn("vcor.assign: symmetrization imposed, diff = %.5g", diff)

    def diag_indices(self):
        return self._diag_idx

    def __str__(self):
        return str(self.evaluate())


def VcorLocal(restricted, bogoliubov, nscsites, idx_range=None, bogo_res=False,
              v_idx=None, ghf=False):
    """Local vcor over idx_range orbitals.

    Parameter layout matches the JAX package (and the reference):
      restricted:    nV = m(m+1)/2 upper-triangle params shared by both spins
      unrestricted:  nV = m(m+1)   first half alpha, second half beta
      bogoliubov:    extra nD pairing params appended
    """
    if idx_range is None:
        idx_range = list(range(nscsites))
    nidx = len(idx_range)
    pairs = list(it.combinations_with_replacement(idx_range, 2))
    npair = len(pairs)

    entries = [[], [], [], [], []]  # pidx, sidx, iidx, jidx, coeff

    def add(p, s, i, j, c):
        entries[0].append(p)
        entries[1].append(s)
        entries[2].append(i)
        entries[3].append(j)
        entries[4].append(c)

    def add_sym(p, s, i, j, c):
        add(p, s, i, j, c)
        if i != j:
            add(p, s, j, i, c)

    if restricted and not bogoliubov:
        if v_idx is not None:
            nV = len(v_idx)
            use_pairs = list(v_idx)
        else:
            nV = npair
            use_pairs = pairs
        nD = 0
        for idx, (i, j) in enumerate(use_pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx, 1, i, j, 1.0)
        if v_idx is not None:
            diag_idx = [np.asarray([k for k, (i, j) in enumerate(v_idx) if i == j])]
        else:
            diag_idx = [triu_diag_indices(nidx)]
        spin_comp = 2
    elif not restricted and not bogoliubov:
        nV = npair * 2
        nD = 0
        for idx, (i, j) in enumerate(pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx + npair, 1, i, j, 1.0)
        d = triu_diag_indices(nidx)
        diag_idx = [d, np.asarray(d) + npair]
        spin_comp = 2
    elif restricted and bogoliubov:
        nV = npair
        nD = npair
        for idx, (i, j) in enumerate(pairs):
            if ghf:
                add_sym(idx, 0, i, j, 1.0)
                add_sym(idx, 1, i, j, -1.0)
            else:
                add_sym(idx, 0, i, j, 1.0)
                add_sym(idx, 1, i, j, 1.0)
            add_sym(idx + nV, 2, i, j, 1.0)
        diag_idx = [triu_diag_indices(nidx)]
        spin_comp = 3
    else:  # unrestricted bogoliubov
        nV = npair * 2
        for idx, (i, j) in enumerate(pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx + npair, 1, i, j, 1.0)
        if bogo_res:
            nD = npair
            for idx, (i, j) in enumerate(pairs):
                add_sym(idx + nV, 2, i, j, 1.0)
        else:
            prod = list(it.product(idx_range, repeat=2))
            nD = len(prod)
            for idx, (i, j) in enumerate(prod):
                add(idx + nV, 2, i, j, 1.0)
        d = triu_diag_indices(nidx)
        diag_idx = [d, np.asarray(d) + npair]
        spin_comp = 3

    return Vcor(nV + nD, spin_comp, nscsites, entries, diag_idx=diag_idx,
                restricted=restricted, bogoliubov=bogoliubov,
                idx_range=idx_range)
