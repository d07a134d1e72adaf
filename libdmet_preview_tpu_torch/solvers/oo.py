"""
Orbital-optimized correlation solvers: OO-MP2 and OO-CCD (PyTorch port of
libdmet_preview_tpu/solvers/oo.py).

One variational program: the total correlated energy

    E(kappa) = E_cc( h, g, C e^kappa )

is a function of the occ-virt rotation parameters, where the amplitude
solve inside E_cc is the implicit-function autograd.Function _TStar
(solvers/cc.py) -- so torch.autograd.grad of E(kappa) through
torch.linalg.matrix_exp and _mo_so_integrals is the exact fully relaxed
orbital gradient (the amplitude response enters through the adjoint
solve of _TStar's backward, one per gradient), and a quasi-Newton
minimization over kappa gives the orbital-optimized solution directly.

For OO-MP2 the amplitude residual is the non-canonical MP2 (Hylleraas)
stationarity condition (cc._residual(mp2=True)), well defined under
arbitrary occ-virt rotations.

At the stationary point dE/dkappa = 0, so the orbital-response term of
the relaxed densities vanishes and the response RDMs at the optimal
orbitals (CCSD._energy_rdms) are the fully relaxed OO densities.

Oracle: for any two-electron system OO-CCD == FCI exactly (Thouless: the
occ-virt rotation absorbs the missing singles).
"""

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.solvers.cc import CCSD, _e_tot_cc


class OOCCD(CCSD):
    """Orbital-optimized CCD.

    run(ImpHam, nelec) -> (rdm1 tensor on `device`, E) with the standard
    solver contract; restricted=True ties the rotation across spins,
    otherwise per-spin occ-virt rotations (UHF / GHF OO modes).  n_eval
    counts the energy-and-gradient evaluations of the last run (each one
    amplitude solve and one adjoint solve)."""

    freeze_t1 = True
    mp2_residual = False

    def __init__(self, restricted=False, Sz=0, tol=1e-9, max_cycle=200,
                 oo_gtol=1e-6, oo_max_iter=100, **kwargs):
        super(OOCCD, self).__init__(restricted=restricted, Sz=Sz, tol=tol,
                                    max_cycle=max_cycle, **kwargs)
        self.oo_gtol = oo_gtol
        self.oo_max_iter = oo_max_iter
        self.oo_converged = False
        self.n_eval = 0

    def run(self, Ham, nelec=None, dm0=None, calc_rdm2=False, **kwargs):
        from libdmet_preview_tpu_torch.ops.fit import minimize
        if nelec is None:
            raise ValueError("%s.run requires nelec"
                             % self.__class__.__name__)
        dev = self.device
        n = Ham.norb
        # ghf: one fermion species over all norb spin orbitals, the beta
        # sector empty, so the generators below span the full spin-orbital
        # occ-virt space
        Ca, Cb, na, nb = self._reference(Ham, nelec, dm0)
        blocks = self._unpack(Ham)
        Cat, Cbt = as_f64(Ca, dev), as_f64(Cb, dev)
        opts = self._opts()

        # occ-virt rotation generators of the reference determinant
        tied = bool(Ham.restricted) and na == nb
        ra = np.repeat(np.arange(na), n - na)
        ca = np.tile(np.arange(na, n), na)
        if tied:
            rb = cb = np.zeros(0, dtype=int)
        else:
            rb = np.repeat(np.arange(nb), n - nb)
            cb = np.tile(np.arange(nb, n), nb)
        npa, npb = len(ra), len(rb)
        npar = npa + npb
        ia = tuple(torch.as_tensor(x, device=dev) for x in (ra, ca))
        ib = tuple(torch.as_tensor(x, device=dev) for x in (rb, cb))

        def _rot(p):
            Ka = torch.zeros((n, n), dtype=p.dtype, device=dev)
            Ka = Ka.index_put(ia, p[:npa])
            Ca_r = Cat @ torch.linalg.matrix_exp(Ka - Ka.T)
            if tied:
                return Ca_r, Ca_r
            Kb = torch.zeros((n, n), dtype=p.dtype, device=dev)
            Kb = Kb.index_put(ib, p[npa:])
            return Ca_r, Cbt @ torch.linalg.matrix_exp(Kb - Kb.T)

        cache = {}

        def fun_grad(x):
            # scipy's BFGS asks for the value and the gradient at the same
            # point in two calls: one evaluation serves both
            key = np.asarray(x, dtype=np.float64).tobytes()
            if key not in cache:
                cache.clear()
                self.n_eval += 1
                p = as_f64(np.asarray(x, dtype=np.float64),
                           dev).requires_grad_(True)
                E = _e_tot_cc(*blocks, *_rot(p), na, nb, opts)
                (g,) = torch.autograd.grad(E, p)
                cache[key] = (float(E.detach()), g.cpu().numpy())
            return cache[key]

        self.n_eval = 0
        if npar:
            with stage("orbital steps", dev):
                p_opt, _ = minimize(fun_grad, np.zeros(npar), method="BFGS",
                                    max_iter=self.oo_max_iter,
                                    gtol=self.oo_gtol)
            gfin = fun_grad(p_opt)[1]
            self.oo_converged = bool(np.max(np.abs(gfin)) < 10
                                     * self.oo_gtol)
            if not self.oo_converged:
                log.warn("%s orbital gradient not tight: max|g| = %.3e",
                         self.__class__.__name__, np.max(np.abs(gfin)))
            with torch.no_grad():
                Ca_o, Cb_o = _rot(as_f64(p_opt, dev))
        else:
            self.oo_converged = True
            Ca_o, Cb_o = Cat, Cbt
        return self._energy_rdms(Ham, Ca_o, Cb_o, na, nb)


class OOMP2(OOCCD):
    """Orbital-optimized MP2: the amplitude equation is the non-canonical
    MP2 stationarity condition, orbitals minimized as in OOCCD."""

    energy_fn = staticmethod(_e_tot_cc)
    mp2_residual = True
