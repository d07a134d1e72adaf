"""
DIIS extrapolation for the vcor parameter vector
(port of libdmet_preview_tpu/ops/diis.py, a host copy: Pulay DIIS as in the
pyscf lib.diis usage of the driver scripts).

The vectors are tiny (nparam ~ 10-100); this is pure numpy on host.
"""

import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


class DIIS(object):
    """Pulay DIIS on a single vector sequence; error vectors are successive
    differences (the pyscf lib.diis.DIIS single-argument behavior)."""

    def __init__(self, space=6, min_space=1):
        self.space = space
        self.min_space = min_space
        self._x = []
        self._err = []
        self._x_prev = None

    def update(self, x, xerr=None):
        x = np.asarray(x, dtype=float).ravel().copy()
        if xerr is not None:
            err = np.asarray(xerr, dtype=float).ravel().copy()
        else:
            if self._x_prev is None:
                # first call: nothing to extrapolate against
                self._x_prev = x.copy()
                return x.copy()
            # residual of the fixed-point map at the previous extrapolate
            err = x - self._x_prev
        self._x.append(x)
        self._err.append(err)
        if len(self._x) > self.space:
            self._x.pop(0)
            self._err.pop(0)
        n = len(self._x)
        if n < self.min_space:
            self._x_prev = x.copy()
            return x.copy()
        B = np.empty((n + 1, n + 1))
        B[:n, :n] = np.asarray([[np.dot(e1, e2) for e2 in self._err]
                                for e1 in self._err])
        B[n, :n] = B[:n, n] = -1.0
        B[n, n] = 0.0
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            log.warn("DIIS singular B matrix; skipping extrapolation")
            self._x_prev = x.copy()
            return x.copy()
        xnew = sum(ci * xi for ci, xi in zip(c, self._x))
        self._x_prev = xnew.copy()
        return xnew

    def get_num_vec(self):
        return len(self._x)


class FDiisContext(object):
    """Thin bookkeeping shim for driver-loop compatibility
    (reference diis.py:34-60); extrapolation itself delegates to DIIS."""

    def __init__(self, nDim):
        self.MaxDim = nDim
        self.nDim = 0
        self.iNext = 0
        self.NotApplied = True
        self._diis = DIIS(space=nDim)

    def Reset(self):
        self.nDim = 0
        self.iNext = 0
        self._diis = DIIS(space=self.MaxDim)

    def Apply(self, T, R):
        T = np.asarray(T).ravel()
        R = np.asarray(R).ravel()
        out = self._diis.update(T, xerr=R)
        self.nDim = self._diis.get_num_vec()
        self.iNext = self.nDim % self.MaxDim
        self.NotApplied = False
        return out.reshape(np.asarray(T).shape), R

    def __str__(self):
        if self.NotApplied:
            return " -  -"
        return "%2i %2i" % (self.nDim, self.iNext)
