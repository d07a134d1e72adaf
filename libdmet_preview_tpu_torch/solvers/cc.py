"""
Coupled-cluster impurity solvers (PyTorch port of
libdmet_preview_tpu/solvers/cc.py: the spin-orbital CCSD core, its adjoint
solve, and the classes CCSD, MP2, CCD, LCCSD, LCCD, CCSD_ITE, BCCSD).

One spin-orbital CCSD core covers RHF / UHF / GHF references.  The amplitude
equations are solved as a preconditioned fixed point with DIIS; amplitudes,
DIIS vectors and the adjoint's Krylov vectors stay on the solver's device,
and the host reads one small tensor per iteration.  The 1- and 2-RDMs are
not hand-coded lambda formulas: the lambda equations are the adjoint of the
amplitude residual, so the amplitude solve is one torch.autograd.Function
(_TStar) whose backward solves the adjoint linear system with
vector-Jacobian products of the residual, and the (unrelaxed response) RDMs
are torch.autograd.grad of the total CC energy with respect to the
spin-blocked site-basis integrals:

    gamma_s = dE/dh_s            (rdm1 spin blocks)
    G_aa = 2 dE/dg_aa,  G_bb = 2 dE/dg_bb,  G_ab = dE/dg_ab

in the DMET chemist convention [aa, bb, ab].

The tailored solver (TCCSD) freezes the CAS-sector amplitudes read out of
an active-space FCI vector (solvers/ci_to_cc.py) and relaxes the rest: its
amplitude solve is a second autograd.Function (_TStarFrozen) whose backward
is the adjoint restricted to the relaxed sector.
"""

import numpy as np
import scipy.linalg as sla
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils import timer
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.utils.timer import stage
from libdmet_preview_tpu_torch.solvers.scf import SCF, _s1_block


# ----------------------------------------------------------------------
# spin-orbital assembly (fixed MO coefficients)
# ----------------------------------------------------------------------

def _mo_so_integrals(h_blocks, g_blocks, Ca, Cb, na, nb):
    """Site-basis spin blocks -> spin-orbital MO integrals, differentiable
    with respect to the blocks.

    Orbital order: [occ_a, occ_b, vir_a, vir_b] so that occupied orbitals
    are the first nocc = na + nb.  Returns (h_so, g_chem_so)."""
    n = Ca.shape[0]
    ha = Ca.T @ h_blocks[0] @ Ca
    hb = Cb.T @ h_blocks[-1] @ Cb

    def ao2mo(g, C1, C2):
        return torch.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, C1, C1, C2, C2)

    g_aa = ao2mo(g_blocks[0], Ca, Ca)
    g_bb = ao2mo(g_blocks[1], Cb, Cb)
    g_ab = ao2mo(g_blocks[2], Ca, Cb)

    # spin-orbital order: alpha MOs [0..n), beta MOs [n..2n), then permute
    # to [occ_a, occ_b, vir_a, vir_b]
    nso = 2 * n
    perm = torch.as_tensor(np.concatenate([
        np.arange(na),                     # occ alpha
        n + np.arange(nb),                 # occ beta
        np.arange(na, n),                  # vir alpha
        n + np.arange(nb, n),              # vir beta
    ]), device=ha.device)
    h_so = torch.zeros((nso, nso), dtype=ha.dtype, device=ha.device)
    h_so[:n, :n] = ha
    h_so[n:, n:] = hb
    g_so = torch.zeros((nso,) * 4, dtype=ha.dtype, device=ha.device)
    g_so[:n, :n, :n, :n] = g_aa
    g_so[n:, n:, n:, n:] = g_bb
    g_so[:n, :n, n:, n:] = g_ab
    g_so[n:, n:, :n, :n] = g_ab.permute(2, 3, 0, 1)
    for axis in range(2):
        h_so = h_so.index_select(axis, perm)
    for axis in range(4):
        g_so = g_so.index_select(axis, perm)
    return h_so, g_so


def _antisymmetrize(g_chem):
    """chemist (pq|rs) -> physicist antisymmetrized <pq||rs>."""
    g_phys = g_chem.permute(0, 2, 1, 3)              # <pq|rs> = (pr|qs)
    return g_phys - g_phys.permute(0, 1, 3, 2)


# ----------------------------------------------------------------------
# CCSD residual (spin-orbital, Stanton JCP 94, 4334 form with full Fock)
# ----------------------------------------------------------------------

def _fock(h_so, W, nocc):
    return h_so + torch.einsum("piqi -> pq", W[:, :nocc, :, :nocc])


def _residual(t1, t2, h_so, W, nocc, mp2=False):
    """Full CCSD residuals (R1, R2) == 0 at convergence.

    W = <pq||rs> antisymmetrized physicist; slices o/v by nocc.

    mp2=True truncates R2 to the non-canonical MP2 stationarity condition
    (Hylleraas functional gradient): only the inhomogeneity W_oovv and the
    one-body Fock contractions survive, R1 = 0."""
    ein = torch.einsum
    o = slice(None, nocc)
    v = slice(nocc, None)
    f = _fock(h_so, W, nocc)

    if mp2:
        R1 = torch.zeros_like(t1)
        R2 = W[o, o, v, v]
        tmp = ein("ijae, be -> ijab", t2, f[v, v])
        R2 = R2 + tmp - tmp.permute(0, 1, 3, 2)
        tmp = ein("imab, mj -> ijab", t2, f[o, o])
        R2 = R2 - tmp + tmp.permute(1, 0, 2, 3)
        return R1, R2

    fov, foo, fvv = f[o, v], f[o, o], f[v, v]
    Woooo = W[o, o, o, o]
    Wooov = W[o, o, o, v]
    Woovv = W[o, o, v, v]
    Wovov = W[o, v, o, v]
    Wovvv = W[o, v, v, v]
    Wvvvv = W[v, v, v, v]
    Wovvo = W[o, v, v, o]
    Wvvvo = W[v, v, v, o]
    Wovoo = W[o, v, o, o]
    Wvovv = -Wovvv.permute(1, 0, 2, 3)
    Woovo = -Wooov.permute(0, 1, 3, 2)

    t1t1 = ein("ia, jb -> ijab", t1, t1) - ein("ib, ja -> ijab", t1, t1)
    tau_t = t2 + 0.5 * t1t1
    tau = t2 + t1t1

    Fae = fvv - 0.5 * ein("me, ma -> ae", fov, t1) \
        + ein("mf, mafe -> ae", t1, Wovvv) \
        - 0.5 * ein("mnaf, mnef -> ae", tau_t, Woovv)
    Fmi = foo + 0.5 * ein("ie, me -> mi", t1, fov) \
        + ein("ne, mnie -> mi", t1, Wooov) \
        + 0.5 * ein("inef, mnef -> mi", tau_t, Woovv)
    Fme = fov + ein("nf, mnef -> me", t1, Woovv)

    Wmnij = Woooo \
        + ein("je, mnie -> mnij", t1, Wooov) \
        - ein("ie, mnje -> mnij", t1, Wooov) \
        + 0.25 * ein("ijef, mnef -> mnij", tau, Woovv)
    Wabef = Wvvvv \
        - ein("mb, amef -> abef", t1, Wvovv) \
        + ein("ma, bmef -> abef", t1, Wvovv) \
        + 0.25 * ein("mnab, mnef -> abef", tau, Woovv)
    Wmbej = Wovvo \
        + ein("jf, mbef -> mbej", t1, Wovvv) \
        - ein("nb, mnej -> mbej", t1, Woovo) \
        - ein("jnfb, mnef -> mbej", 0.5 * t2, Woovv) \
        - ein("jf, nb, mnef -> mbej", t1, t1, Woovv)

    # T1 residual
    R1 = fov \
        + ein("ie, ae -> ia", t1, Fae) \
        - ein("ma, mi -> ia", t1, Fmi) \
        + ein("imae, me -> ia", t2, Fme) \
        - ein("nf, naif -> ia", t1, Wovov) \
        - 0.5 * ein("imef, maef -> ia", t2, Wovvv) \
        - 0.5 * ein("mnae, nmei -> ia", t2, Woovo)

    # T2 residual
    Fbe2 = Fae - 0.5 * ein("mb, me -> be", t1, Fme)
    Fmj2 = Fmi + 0.5 * ein("je, me -> mj", t1, Fme)

    tmp = ein("ijae, be -> ijab", t2, Fbe2)
    R2 = Woovv + tmp - tmp.permute(0, 1, 3, 2)
    tmp = ein("imab, mj -> ijab", t2, Fmj2)
    R2 = R2 - tmp + tmp.permute(1, 0, 2, 3)
    R2 = R2 + 0.5 * ein("mnab, mnij -> ijab", tau, Wmnij)
    R2 = R2 + 0.5 * ein("ijef, abef -> ijab", tau, Wabef)
    tmp = ein("imae, mbej -> ijab", t2, Wmbej) \
        - ein("ie, ma, mbej -> ijab", t1, t1, Wovvo)
    tmp = tmp - tmp.permute(1, 0, 2, 3)
    R2 = R2 + tmp - tmp.permute(0, 1, 3, 2)
    tmp = ein("ie, abej -> ijab", t1, Wvvvo)
    R2 = R2 + tmp - tmp.permute(1, 0, 2, 3)
    tmp = ein("ma, mbij -> ijab", t1, Wovoo)
    R2 = R2 - tmp + tmp.permute(0, 1, 3, 2)
    return R1, R2


def _ecorr(t1, t2, h_so, W, nocc):
    o = slice(None, nocc)
    v = slice(nocc, None)
    f = _fock(h_so, W, nocc)
    Woovv = W[o, o, v, v]
    e = torch.sum(f[o, v] * t1)
    e = e + 0.25 * torch.sum(Woovv * t2)
    e = e + 0.5 * torch.einsum("ijab, ia, jb ->", Woovv, t1, t1)
    return e


def _denominators(h_so, W, nocc):
    eps = torch.diagonal(_fock(h_so, W, nocc))
    eo, ev = eps[:nocc], eps[nocc:]
    D1 = eo[:, None] - ev[None, :]
    D2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    return D1, D2


def _e_ref(h_so, W, nocc):
    o = slice(None, nocc)
    return torch.einsum("ii ->", h_so[o, o]) \
        + 0.5 * torch.einsum("ijij ->", W[o, o, o, o])


class _AmpDIIS(object):
    """Pulay DIIS over stacked (t1, t2) amplitude vectors, on the vectors'
    device: the trial and error vectors live in two (space, size) buffers
    there, and an update reads one small tensor to the host (the new row
    of the B matrix, with any scalars the caller wants read beside it),
    solves the (space + 1) system on the host and combines the stored
    vectors on the device."""

    def __init__(self, shapes, space=8):
        self.space = space
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self._x = None
        self._err = None
        self._order = []           # buffer rows, oldest first
        self._B = np.zeros((0, 0))

    def _stack(self, ts, out):
        k = 0
        for t, sz in zip(ts, self.sizes):
            out[k:k + sz] = t.reshape(-1)
            k += sz

    def update(self, ts, errs, scalars=()):
        """Store (ts, errs) and extrapolate.  Returns (the extrapolated
        tensors, the host values of `scalars` (0-d tensors) as floats)."""
        ref = ts[0]
        if self._x is None:
            shape = (self.space, sum(self.sizes))
            self._x = torch.empty(shape, dtype=ref.dtype, device=ref.device)
            self._err = torch.empty_like(self._x)
        if len(self._order) == self.space:
            row = self._order.pop(0)
            self._B = self._B[1:, 1:]
        else:
            row = len(self._order)
        self._stack(ts, self._x[row])
        self._stack(errs, self._err[row])
        self._order.append(row)
        n = len(self._order)
        idx = torch.as_tensor(self._order, device=ref.device)
        dots = self._err[idx] @ self._err[row]
        read = torch.cat([dots] + [s.reshape(1) for s in scalars]).cpu().numpy()
        B = np.empty((n + 1, n + 1))
        B[:n - 1, :n - 1] = self._B
        B[n - 1, :n] = B[:n, n - 1] = read[:n]
        self._B = B[:n, :n].copy()
        B[n, :n] = B[:n, n] = -1.0
        B[n, n] = 0.0
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            log.warn("DIIS singular B matrix; skipping extrapolation")
            c = np.zeros(n)
            c[-1] = 1.0
        flat = torch.as_tensor(c, dtype=ref.dtype, device=ref.device) \
            @ self._x[idx]
        out, k = [], 0
        for s, sz in zip(self.shapes, self.sizes):
            out.append(flat[k:k + sz].reshape(s))
            k += sz
        return out, [float(x) for x in read[n:]]


def _solve_amplitudes(h_so, W, nocc, tol=1e-9, max_cycle=100, diis_space=8,
                      freeze_t1=False, lambda_sweeps=None, ite_dtau=None,
                      level_shift=0.0, mp2=False):
    # lambda_sweeps is consumed by the adjoint solve (approximate-lambda
    # variants); it does not affect the amplitude fixed point
    """Preconditioned fixed point t <- t + R/D with DIIS, on the device of
    h_so; one host read per iteration, each counted as "cc amplitude
    steps" (utils.timer).  Returns (t1, t2, converged);
    _solve_amplitudes.last holds the iterations and the final max|R| of
    the latest call.  A max|R| that is not finite ends the iteration.

    freeze_t1=True solves CCD (singles pinned at zero).
    ite_dtau: imaginary-time-evolution update t <- t + dtau * R instead of
    the quasi-Newton R/D step: unpreconditioned but robust for
    near-degenerate denominators; converges for dtau < 2/|D|_max (DIIS
    accelerates either update).
    level_shift: added to |D|: damps the quasi-Newton step where the
    update map's spectral radius exceeds 1 (small-gap d manifolds); the
    fixed point is unchanged since the converged residual is zero."""
    with torch.no_grad():
        D1, D2 = _denominators(h_so, W, nocc)
        if level_shift:
            D1 = D1 - level_shift
            D2 = D2 - level_shift
        nvir = h_so.shape[0] - nocc
        t1 = torch.zeros((nocc, nvir), dtype=h_so.dtype, device=h_so.device)
        t2 = W[:nocc, :nocc, nocc:, nocc:] / D2
        diis = _AmpDIIS([(nocc, nvir), (nocc, nocc, nvir, nvir)],
                        space=diis_space)
        conv = False
        rnorm = float("inf")
        it = -1
        for it in range(max_cycle):
            R1, R2 = _residual(t1, t2, h_so, W, nocc, mp2=mp2)
            if freeze_t1:
                R1 = torch.zeros_like(R1)
            rn = torch.max(torch.abs(R1)) + torch.max(torch.abs(R2))
            if ite_dtau is not None:
                # D < 0 for a gapped reference, so the descent direction of
                # the quasi-Newton step R/D is -R
                s1, s2 = -ite_dtau * R1, -ite_dtau * R2
            else:
                s1, s2 = R1 / D1, R2 / D2
            (t1, t2), (rnorm,) = diis.update([t1 + s1, t2 + s2], [s1, s2],
                                             scalars=(rn,))
            timer.count("cc amplitude steps")
            log.debug(1, "CC amplitudes: iteration %3d max|R| = %.3e",
                      it, rnorm)
            if rnorm < tol:
                conv = True
                break
            if not np.isfinite(rnorm):
                break
    if not conv:
        log.warn("CCSD amplitudes not converged: max|R| = %.3e", rnorm)
    _solve_amplitudes.last = {"iterations": it + 1, "max|R|": rnorm,
                              "converged": conv}
    return t1, t2, conv


_solve_amplitudes.last = None


def _P2(x2):
    """Projector onto the antisymmetric t2 subspace.  The full (i, j, a, b)
    storage is 4x redundant, and the residual Jacobian on the redundant
    directions carries a large artificial kernel that mixes into the
    physical subspace.  The amplitude iteration lives on the antisymmetric
    invariant manifold, so the correct adjoint is the projected system
    P J^T P lam = P b, which is consistent and nonsingular for a gapped
    reference."""
    return 0.25 * (x2 - x2.permute(1, 0, 2, 3) - x2.permute(0, 1, 3, 2)
                   + x2.permute(1, 0, 3, 2))


def _grad_or_zeros(outputs, inputs, cotangents, retain_graph=False):
    """Vector-Jacobian product of `outputs` with respect to `inputs`;
    outputs that do not depend on the inputs are left out and inputs that
    no output depends on get zeros."""
    pairs = [(y, c) for y, c in zip(outputs, cotangents) if y.requires_grad]
    if not pairs:
        return tuple(torch.zeros_like(x) for x in inputs)
    grads = torch.autograd.grad([y for y, _ in pairs], inputs,
                                [c for _, c in pairs],
                                retain_graph=retain_graph, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs))


def _adjoint_operators(h_so, W, nocc, t1, t2, D1, D2, freeze_t1=False,
                       mp2=False):
    """(matvec, rmatvec) of the projected, Jacobi right-preconditioned
    adjoint operator A = P J^T P D^-1 at the amplitudes (t1, t2), on pairs
    (l1, l2) of tensors.  The residual's graph is built once here; matvec
    is one backward pass through it, rmatvec (A^T = D^-1 P J P, used only
    by the least-squares fallback) one forward-mode product."""
    t1g = t1.detach().clone().requires_grad_(True)
    t2g = t2.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        R = _residual(t1g, t2g, h_so, W, nocc, mp2=mp2)

    def vjp_t(c1, c2):
        return _grad_or_zeros(R, (t1g, t2g), (c1, c2), retain_graph=True)

    def matvec(l1, l2):
        # D2 is symmetric under the transpositions, so 1/D commutes with
        # the projector
        l2 = _P2(l2)
        if freeze_t1:
            # CCD: the t1 sector is pinned -> identity block, lam1 = 0
            _, g2 = vjp_t(torch.zeros_like(l1), l2 / D2)
            return l1, _P2(g2)
        g1, g2 = vjp_t(l1 / D1, l2 / D2)
        return g1, _P2(g2)

    def Rt(a, b):
        return _residual(a, b, h_so, W, nocc, mp2=mp2)

    def rmatvec(y1, y2):
        y2 = _P2(y2)
        tangent = (torch.zeros_like(y1) if freeze_t1 else y1, y2)
        _, (g1, g2) = torch.func.jvp(Rt, (t1.detach(), t2.detach()), tangent)
        if freeze_t1:
            return y1, _P2(g2) / D2
        return g1 / D1, _P2(g2) / D2

    return matvec, rmatvec


def _solve_adjoint(h_so, W, nocc, t1, t2, w1, w2, tol=1e-9, max_cycle=100,
                   diis_space=8, freeze_t1=False, lambda_sweeps=None,
                   ite_dtau=None, level_shift=0.0, mp2=False):
    # ite_dtau only affects the amplitude iteration; the adjoint solve is
    # a linear system independent of how the fixed point was reached;
    # level_shift enters only the Jacobi preconditioner (same damping as
    # the amplitude iteration -- the linear system itself is unshifted)
    """Solve (dR/dt)^T lam = -(w1, w2): the lambda equations as an adjoint
    linear system, with vector-Jacobian products of the residual as the
    matvec.  DIIS-accelerated Richardson on the Jacobi-preconditioned
    operator, on the device; then, only if it stalls, GMRES, a min-norm
    least-squares LSMR and (small systems) a dense solve, through scipy on
    the host.  Each operator application counts one "cc adjoint matvecs"
    (utils.timer).  _solve_adjoint.last holds the matvecs, the final relative
    residual and the branch that ended the latest call.

    lambda_sweeps: if set, do that many Jacobi-preconditioned Richardson
    sweeps instead of the exact solve -- the approximate-lambda CC family:
    lambda correct to the given order in the fluctuation, RDMs cheaper and
    O(t^2)-approximate."""
    with torch.no_grad():
        D1, D2 = _denominators(h_so, W, nocc)
        if level_shift:
            D1 = D1 - level_shift
            D2 = D2 - level_shift
    s1, s2 = tuple(w1.shape), tuple(w2.shape)
    n1 = int(np.prod(s1))
    ntot = n1 + int(np.prod(s2))

    matvec, rmatvec = _adjoint_operators(h_so, W, nocc, t1, t2, D1, D2,
                                         freeze_t1=freeze_t1, mp2=mp2)
    count = {"matvec": 0}
    _solve_adjoint.calls += 1

    def split(x):
        return x[:n1].reshape(s1), x[n1:].reshape(s2)

    def A(x):
        count["matvec"] += 1
        timer.count("cc adjoint matvecs")
        g1, g2 = matvec(*split(x))
        return torch.cat([g1.reshape(-1), g2.reshape(-1)])

    def finish(x, res, branch):
        l1, l2 = split(x)
        _solve_adjoint.last = {"matvecs": count["matvec"],
                               "residual": res, "branch": branch}
        return l1 / D1, l2 / D2

    with torch.no_grad():
        if freeze_t1:
            w1 = torch.zeros_like(w1)
        b = -torch.cat([w1.reshape(-1), _P2(w2).reshape(-1)])
        bnorm = max(1.0, float(torch.linalg.norm(b)))
        if lambda_sweeps is not None:
            # approximate lambda: truncated Richardson on the preconditioned
            # system.  The Jacobi-preconditioned adjoint is ~ -I (the
            # residual Jacobian diagonal is -D), so relax with omega = -1
            # and start at -b (1 sweep == linearized lambda)
            x = -b
            for _ in range(int(lambda_sweeps) - 1):
                x = x - (b - A(x))
            return finish(x, None, "lambda_sweeps")
        # DIIS-accelerated Richardson on the preconditioned adjoint first:
        # the same contraction structure as the (converged) amplitude fixed
        # point, so whenever the t iteration converged this does too -- and
        # at ~1 vjp/iteration it is far cheaper than restarted GMRES, which
        # stalls on near-degenerate denominators (small emb gaps).  The
        # squared residual norm is the new diagonal entry of the DIIS
        # matrix, so it is read with it
        diis = _AmpDIIS([(ntot,)], space=diis_space)
        x = b.clone()
        res_norm = float("inf")
        branch = "diis-richardson"
        for _ in range(max_cycle):
            e = A(x) - b
            (x_new,), (ee,) = diis.update([x - e], [e],
                                          scalars=(torch.dot(e, e),))
            res_norm = float(np.sqrt(ee))
            log.debug(1, "CC adjoint: matvec %3d |A x - b| = %.3e",
                      count["matvec"], res_norm)
            if res_norm < max(tol, 1e-10) * bnorm:
                break
            x = x_new
    if res_norm > 1e-8 * bnorm:
        x, res_norm, branch = _adjoint_fallbacks(
            A, rmatvec, split, x, b, res_norm, bnorm, tol, ntot, branch)
    if res_norm > 1e-6 * bnorm:
        log.warn("CCSD adjoint (lambda) solve residual %.3e", res_norm)
    return finish(x, res_norm / bnorm, branch)


_solve_adjoint.last = None
_solve_adjoint.calls = 0     # adjoint solves since import (or a reset)


def _adjoint_fallbacks(A, rmatvec, split, x, b, res_norm, bnorm, tol, ntot,
                       branch):
    """The rare paths behind a stalled Richardson iteration, through scipy
    on the host (each matvec copies its vector to the device and back):
    GMRES, then LSMR where rmatvec is given, then (small systems) a dense
    solve."""
    from scipy.sparse.linalg import LinearOperator, gmres, lsmr
    dev, dtype = b.device, b.dtype

    def to_dev(v):
        # scipy's LinearOperator probes matvec with an int8 vector to
        # infer the dtype
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=dev)

    def mv(v):
        with torch.no_grad():
            return A(to_dev(v)).cpu().numpy()

    def rmv(v):
        g1, g2 = rmatvec(*split(to_dev(v)))
        return torch.cat([g1.reshape(-1), g2.reshape(-1)]).cpu().numpy()

    bh = b.cpu().numpy()
    xh = x.cpu().numpy()
    log.info("CCSD adjoint: Richardson residual %.2e, GMRES", res_norm)
    Aop = LinearOperator((ntot, ntot), matvec=mv, dtype=np.float64)
    # scipy holds restart + 1 Krylov vectors on the host: at most ~4 GB
    restart = max(20, min(ntot, 400, int(5e8 // ntot)))
    x2, _ = gmres(Aop, bh, rtol=max(tol, 1e-12), atol=0.0, x0=xh,
                  restart=restart, maxiter=5)
    r2 = float(np.linalg.norm(mv(x2) - bh))
    if r2 < res_norm:
        xh, res_norm, branch = x2, r2, "gmres"
    if res_norm > 1e-6 * bnorm and rmatvec is not None:
        # Krylov stall on an indefinite / defective adjoint (a zero EOM
        # eigenvalue makes the Jacobian singular, and if b overlaps the
        # cokernel the lambda equations are inconsistent -- CC response
        # breaks down at such points).  Regularize as the min-norm
        # least-squares lambda via LSMR; the transpose matvec is the jvp
        # of the residual (A = J^T D^{-1} => A^T = D^{-1} J).
        log.info("CCSD adjoint: GMRES residual %.2e, least-squares LSMR",
                 res_norm)
        Als = LinearOperator((ntot, ntot), matvec=mv, rmatvec=rmv,
                             dtype=np.float64)
        xl = lsmr(Als, bh, atol=1e-12, btol=1e-12, maxiter=3000)[0]
        el = mv(xl) - bh
        rl = float(np.linalg.norm(el))
        rlsq = float(np.linalg.norm(rmv(el)))
        if rl < res_norm or rlsq < 1e-8 * bnorm:
            xh, res_norm, branch = xl, rl, "lsmr"
            if res_norm > 1e-6 * bnorm:
                log.warn("CCSD adjoint is singular-inconsistent "
                         "(defective CC Jacobian: zero EOM mode "
                         "overlapping dE/dt); min-norm least-squares "
                         "lambda, cokernel residual %.3e", res_norm)
    if res_norm > 1e-8 * bnorm and ntot <= 3000:
        # small system: materialize the Jacobian and solve directly
        log.info("CCSD adjoint: GMRES residual %.2e, dense direct solve",
                 res_norm)
        eye = np.eye(ntot)
        Adense = np.asarray([mv(eye[:, k]) for k in range(ntot)]).T
        # lstsq: the Jacobian is singular on spin-forbidden amplitude
        # sectors (zero rows; b vanishes there too) -> minimum-norm solve
        xh = np.linalg.lstsq(Adense, bh, rcond=None)[0]
        res_norm = float(np.linalg.norm(Adense @ xh - bh))
        branch = "dense"
    return to_dev(xh), res_norm, branch


# amplitude solve with implicit differentiation --------------------------

class _TStar(torch.autograd.Function):
    """(h_so, W) -> the converged amplitudes (t1, t2).  Forward: the
    amplitude fixed point, outside autograd.  Backward: the lambda
    equations as the adjoint system at the fixed point, then the
    vector-Jacobian product of the residual with respect to (h_so, W) at
    fixed amplitudes."""

    @staticmethod
    def forward(ctx, h_so, W, nocc, opts):
        with stage("CC amplitudes", h_so.device):
            t1, t2, _ = _solve_amplitudes(h_so.detach(), W.detach(), nocc,
                                          **dict(opts))
        ctx.save_for_backward(h_so, W, t1, t2)
        ctx.nocc, ctx.opts = nocc, opts
        return t1, t2

    @staticmethod
    def backward(ctx, w1, w2):
        h_so, W, t1, t2 = (x.detach() for x in ctx.saved_tensors)
        nocc, opts = ctx.nocc, dict(ctx.opts)
        with stage("CC adjoint", h_so.device):
            lam1, lam2 = _solve_adjoint(h_so, W, nocc, t1, t2, w1, w2,
                                        **opts)
        with stage("CC residual vjp to integrals", h_so.device):
            h_ = h_so.detach().requires_grad_(True)
            W_ = W.detach().requires_grad_(True)
            with torch.enable_grad():
                R = _residual(t1, t2, h_, W_, nocc,
                              mp2=opts.get("mp2", False))
            gh, gW = _grad_or_zeros(R, (h_, W_), (lam1, lam2))
        return gh, gW, None, None


def _t_star(h_so, W, nocc, opts):
    return _TStar.apply(h_so, W, nocc, opts)


# total energy as a function of the site-basis integral blocks -----------

def _e_tot_cc(h1a, h1b, g_aa, g_bb, g_ab, Ca, Cb, na, nb, opts):
    nocc = int(na + nb)
    with stage("CC ao2mo", h1a.device):
        h_so, g_chem = _mo_so_integrals((h1a, h1b), (g_aa, g_bb, g_ab),
                                        Ca, Cb, na, nb)
        W = _antisymmetrize(g_chem)
        del g_chem
    t1, t2 = _t_star(h_so, W, nocc, opts)
    return _e_ref(h_so, W, nocc) + _ecorr(t1, t2, h_so, W, nocc)


def _e_tot_mp2(h1a, h1b, g_aa, g_bb, g_ab, Ca, Cb, na, nb, opts=None):
    """MP2 total energy: closed-form t2; autograd gives response RDMs."""
    nocc = int(na + nb)
    h_so, g_chem = _mo_so_integrals((h1a, h1b), (g_aa, g_bb, g_ab),
                                    Ca, Cb, na, nb)
    W = _antisymmetrize(g_chem)
    _, D2 = _denominators(h_so, W, nocc)
    Woovv = W[:nocc, :nocc, nocc:, nocc:]
    return _e_ref(h_so, W, nocc) + 0.25 * torch.sum(Woovv * (Woovv / D2))


# tailored CC: frozen CAS amplitudes, relaxed complement -----------------

def _solve_amplitudes_frozen(h_so, W, m1, t1f, m2, t2f, nocc, tol=1e-9,
                             max_cycle=100, diis_space=8):
    """Fixed point with frozen amplitude sectors (tailored CC), on the
    device of h_so: entries where m == 1 stay at the supplied values; only
    the complement relaxes.  Returns (t1, t2, converged);
    _solve_amplitudes_frozen.last holds the iterations and the final
    max|R|."""
    with torch.no_grad():
        D1, D2 = _denominators(h_so, W, nocc)
        f1, f2 = m1 > 0, m2 > 0
        t1 = torch.where(f1, t1f, torch.zeros_like(t1f))
        t2 = torch.where(f2, t2f, W[:nocc, :nocc, nocc:, nocc:] / D2)
        diis = _AmpDIIS([tuple(t1.shape), tuple(t2.shape)],
                        space=diis_space)
        conv = False
        rnorm = float("inf")
        it = -1
        for it in range(max_cycle):
            R1, R2 = _residual(t1, t2, h_so, W, nocc)
            R1 = torch.where(f1, torch.zeros_like(R1), R1)
            R2 = torch.where(f2, torch.zeros_like(R2), R2)
            rn = torch.max(torch.abs(R1)) + torch.max(torch.abs(R2))
            s1, s2 = R1 / D1, R2 / D2
            (t1, t2), (rnorm,) = diis.update([t1 + s1, t2 + s2], [s1, s2],
                                             scalars=(rn,))
            t1 = torch.where(f1, t1f, t1)
            t2 = torch.where(f2, t2f, t2)
            log.debug(1, "TCC amplitudes: iteration %3d max|R| = %.3e",
                      it, rnorm)
            if rnorm < tol:
                conv = True
                break
    if not conv:
        log.warn("tailored CC amplitudes not converged: max|R| = %.3e",
                 rnorm)
    _solve_amplitudes_frozen.last = {"iterations": it + 1, "max|R|": rnorm,
                                     "converged": conv}
    return t1, t2, conv


_solve_amplitudes_frozen.last = None


def _masked_adjoint_operator(h_so, W, nocc, t1, t2, m1, m2):
    """The tailored adjoint operator x -> A x on the relaxed amplitude
    sector and the identity on the frozen entries (m == 1), as a flat
    vector map, with its (split, D1, D2): the graph of the residual at
    (t1, t2) is built once and each matvec is one vjp through it."""
    with torch.no_grad():
        D1, D2 = _denominators(h_so, W, nocc)
    f1, f2 = m1 > 0, m2 > 0
    s1, s2 = tuple(t1.shape), tuple(t2.shape)
    n1 = int(np.prod(s1))
    t1g = t1.detach().clone().requires_grad_(True)
    t2g = t2.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        R = _residual(t1g, t2g, h_so, W, nocc)

    def split(x):
        return x[:n1].reshape(s1), x[n1:].reshape(s2)

    def A(x):
        # the antisymmetric-subspace projector commutes with the masking:
        # the CAS freeze masks are invariant under the ij / ab
        # transpositions
        l1, l2 = split(x)
        l1_in = torch.where(f1, torch.zeros_like(l1), l1 / D1)
        l2_in = torch.where(f2, torch.zeros_like(l2), _P2(l2) / D2)
        g1, g2 = _grad_or_zeros(R, (t1g, t2g), (l1_in, l2_in),
                                retain_graph=True)
        g1 = torch.where(f1, l1, g1)
        g2 = torch.where(f2, l2, _P2(g2))
        return torch.cat([g1.reshape(-1), g2.reshape(-1)])

    return A, split, D1, D2


def _solve_adjoint_masked(h_so, W, nocc, t1, t2, w1, w2, m1, m2, tol=1e-9,
                          max_cycle=100, diis_space=8):
    """Adjoint linear solve on the relaxed amplitude sector: identity on
    the frozen entries (lam there = 0).  DIIS-accelerated Richardson on
    the device, then GMRES and (small systems) a dense solve on the host.
    _solve_adjoint_masked.last holds the matvecs, the final relative
    residual and the branch that ended the latest call; .calls counts the
    solves."""
    _solve_adjoint_masked.calls += 1
    A_, split, D1, D2 = _masked_adjoint_operator(h_so, W, nocc, t1, t2,
                                                  m1, m2)
    f1, f2 = m1 > 0, m2 > 0
    ntot = t1.numel() + t2.numel()
    count = {"matvec": 0}

    def A(x):
        count["matvec"] += 1
        return A_(x)

    with torch.no_grad():
        b = -torch.cat([w1.reshape(-1), w2.reshape(-1)])
        bnorm = max(1.0, float(torch.linalg.norm(b)))
        diis = _AmpDIIS([(ntot,)], space=diis_space)
        x = b.clone()
        res_norm = float("inf")
        branch = "diis-richardson"
        for _ in range(max_cycle):
            e = A(x) - b
            (x_new,), (ee,) = diis.update([x - e], [e],
                                          scalars=(torch.dot(e, e),))
            res_norm = float(np.sqrt(ee))
            log.debug(1, "TCC adjoint: matvec %3d |A x - b| = %.3e",
                      count["matvec"], res_norm)
            if res_norm < max(tol, 1e-10) * bnorm:
                break
            x = x_new
    if res_norm > 1e-8 * bnorm:
        x, res_norm, branch = _adjoint_fallbacks(
            A, None, split, x, b, res_norm, bnorm, tol, ntot, branch)
    if res_norm > 1e-6 * bnorm:
        log.warn("tailored CC adjoint solve residual %.3e", res_norm)
    _solve_adjoint_masked.last = {"matvecs": count["matvec"],
                                  "residual": res_norm / bnorm,
                                  "branch": branch}
    l1, l2 = split(x)
    return (torch.where(f1, torch.zeros_like(l1), l1 / D1),
            torch.where(f2, torch.zeros_like(l2), l2 / D2))


_solve_adjoint_masked.last = None
_solve_adjoint_masked.calls = 0


class _TStarFrozen(torch.autograd.Function):
    """(h_so, W) -> the tailored amplitudes (t1, t2) with the entries
    where (m1, m2) are set frozen at (t1f, t2f).  Forward: the relaxation
    of the external amplitudes, outside autograd.  Backward: the adjoint
    restricted to the relaxed sector (the frozen amplitudes do not respond
    to the integrals at a fixed CAS solution: their cotangents are dropped
    and the frozen inputs receive none), then the vector-Jacobian product
    of the residual with respect to (h_so, W) at fixed amplitudes."""

    @staticmethod
    def forward(ctx, h_so, W, m1, t1f, m2, t2f, nocc, opts):
        with stage("TCC amplitudes", h_so.device):
            t1, t2, _ = _solve_amplitudes_frozen(
                h_so.detach(), W.detach(), m1, t1f, m2, t2f, nocc,
                **dict(opts))
        ctx.save_for_backward(h_so, W, m1, m2, t1, t2)
        ctx.nocc, ctx.opts = nocc, opts
        return t1, t2

    @staticmethod
    def backward(ctx, w1, w2):
        h_so, W, m1, m2, t1, t2 = (x.detach() for x in ctx.saved_tensors)
        nocc = ctx.nocc
        w1 = torch.where(m1 > 0, torch.zeros_like(w1), w1)
        w2 = torch.where(m2 > 0, torch.zeros_like(w2), w2)
        with stage("TCC adjoint", h_so.device):
            lam1, lam2 = _solve_adjoint_masked(h_so, W, nocc, t1, t2, w1, w2,
                                               m1, m2, **dict(ctx.opts))
        with stage("TCC residual vjp to integrals", h_so.device):
            h_ = h_so.requires_grad_(True)
            W_ = W.requires_grad_(True)
            with torch.enable_grad():
                R = _residual(t1, t2, h_, W_, nocc)
            gh, gW = _grad_or_zeros(R, (h_, W_), (lam1, lam2))
        return gh, gW, None, None, None, None, None, None


def _e_tot_tcc(h1a, h1b, g_aa, g_bb, g_ab, Ca, Cb, na, nb, opts,
               m1, t1f, m2, t2f):
    nocc = int(na + nb)
    with stage("CC ao2mo", h1a.device):
        h_so, g_chem = _mo_so_integrals((h1a, h1b), (g_aa, g_bb, g_ab),
                                        Ca, Cb, na, nb)
        W = _antisymmetrize(g_chem)
        del g_chem
    t1, t2 = _TStarFrozen.apply(h_so, W, m1, t1f, m2, t2f, nocc, opts)
    return _e_ref(h_so, W, nocc) + _ecorr(t1, t2, h_so, W, nocc)


# ----------------------------------------------------------------------
# solver classes (contract: run / run_dmet_ham / make_rdm2)
# ----------------------------------------------------------------------

class CCSD(object):
    """CCSD impurity solver: run(ImpHam, nelec) -> (rdm1 (spin, n, n)
    tensor on `device`, E).

    restricted=True accepts spin-restricted Integrals (internally UHF-style
    spin orbitals with Ca == Cb); Sz fixes na - nb.  RDMs are exact
    unrelaxed CC response densities via implicit differentiation."""

    energy_fn = staticmethod(_e_tot_cc)

    freeze_t1 = False

    lambda_sweeps = None

    def __init__(self, restricted=False, Sz=0, tol=1e-9, max_cycle=200,
                 scf_newton=False, diis_space=8, level_shift=0.0,
                 ghf=False, device=torch.device("cuda"), **kwargs):
        self.restricted = restricted
        self.ghf = ghf              # GSO: one species over all orbitals
        self.Sz = Sz
        self.conv_tol = tol
        self.max_cycle = max_cycle
        self.diis_space = diis_space
        self.level_shift = level_shift
        self.device = torch.device(device)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.scfsolver = None
        self._mo = None
        self.optimized = False

    def _opts(self):
        opts = (("tol", self.conv_tol), ("max_cycle", self.max_cycle),
                ("diis_space", self.diis_space))
        if self.freeze_t1:
            opts = opts + (("freeze_t1", True),)
        if self.lambda_sweeps is not None:
            opts = opts + (("lambda_sweeps", int(self.lambda_sweeps)),)
        if getattr(self, "ite_dtau", None) is not None:
            opts = opts + (("ite_dtau", float(self.ite_dtau)),)
        if getattr(self, "level_shift", 0.0):
            opts = opts + (("level_shift", float(self.level_shift)),)
        if getattr(self, "mp2_residual", False):
            opts = opts + (("mp2", True),)
        return opts

    # -- integral unpacking ------------------------------------------
    def _unpack(self, Ham):
        """(h1a, h1b, g_aa, g_bb, g_ab) as s1 tensors on the device."""
        n = Ham.norb
        H1 = as_f64(Ham.H1["cd"], self.device)
        h1a = H1[0]
        h1b = H1[1] if H1.shape[0] == 2 else H1[0]
        H2 = Ham.H2["ccdd"]
        if len(H2) == 1:
            g = _s1_block(H2[0], n, self.device)
            return h1a, h1b, g, g, g
        return (h1a, h1b) + tuple(_s1_block(H2[i], n, self.device)
                                  for i in range(3))

    def _reference(self, Ham, nelec, dm0):
        """Embedded HF on the device; returns (Ca, Cb, na, nb) with host
        MO coefficients."""
        if self.ghf:
            # GSO / generalized spin orbitals: a single fermion species
            # over all norb orbitals -- run the spin-orbital machinery with
            # (nelec, 0) electrons and return full (unhalved)
            # single-species RDMs matching the FCI(ghf=True) contract
            na, nb = nelec, 0
            spin, restricted = nelec, False
        else:
            na = (nelec + self.Sz) // 2
            nb = nelec - na
            spin, restricted = self.Sz, self.restricted
        self.scfsolver = SCF(device=self.device)
        self.scfsolver.set_system(nelec, spin, False, restricted)
        self.scfsolver.set_integral(Ham)
        with stage("CC reference SCF", self.device):
            self.scfsolver.HF(tol=min(self.conv_tol, 1e-10), MaxIter=200,
                              InitGuess=dm0)
        mo = self.scfsolver.mo_coeff
        return mo[0], (mo[1] if mo.shape[0] == 2 else mo[0]), na, nb

    def run(self, Ham, nelec=None, dm0=None, calc_rdm2=False, **kwargs):
        if nelec is None:
            raise ValueError("CCSD.run requires nelec")
        Ca, Cb, na, nb = self._reference(Ham, nelec, dm0)
        return self._energy_rdms(Ham, Ca, Cb, na, nb)

    def _energy_rdms(self, Ham, Ca, Cb, na, nb, opts=None, extra=()):
        """Total energy + response RDMs at fixed MO coefficients (the
        tail of run(); also the finalizer for orbital-optimized solvers,
        where the orbital-response term of the relaxed RDMs vanishes at
        the stationary point).  extra: further arguments of energy_fn."""
        self._mo = (Ca, Cb, na, nb)
        if opts is None:
            opts = self._opts()
        # one leaf per argument, also where a restricted Hamiltonian
        # passes one block three times: each gets its own partial
        # derivative
        blocks = [x.detach().requires_grad_(True) for x in self._unpack(Ham)]
        val = self.__class__.energy_fn(*blocks, as_f64(Ca, self.device),
                                       as_f64(Cb, self.device), na, nb, opts,
                                       *extra)
        E = float(val.detach()) + float(Ham.H0)
        if not np.isfinite(E):
            # NaN densities would reach the dmu search and fail later, in
            # an eigensolver far from the cause
            scf = self.scfsolver
            raise RuntimeError(
                "%s: the energy is not finite, because %s" % (
                    type(self).__name__,
                    "the reference SCF did not converge"
                    if scf is not None and not scf.converged
                    else "the amplitudes diverged"))
        with stage("CC gradient (adjoint and vjp inside)", self.device):
            grads = torch.autograd.grad(val, blocks)
        gh1a, gh1b, gg_aa, gg_bb, gg_ab = grads
        del grads, blocks, val

        rdm1_a = 0.5 * (gh1a + gh1a.T)
        rdm1_b = 0.5 * (gh1b + gh1b.T)
        # G_aa = 2 dE/dg_aa, G_bb = 2 dE/dg_bb, G_ab = dE/dg_ab, with the
        # chemist index symmetry enforced
        G_aa = gg_aa + gg_aa.permute(1, 0, 3, 2)
        G_bb = gg_bb + gg_bb.permute(1, 0, 3, 2)
        G_ab = 0.5 * (gg_ab + gg_ab.permute(1, 0, 3, 2))

        if self.ghf:
            self.onepdm = rdm1_a[None]
            self.twopdm = G_aa[None]
        elif Ham.restricted:
            self.onepdm = (0.5 * (rdm1_a + rdm1_b))[None]
            # combined restricted block: G_tot = G_aa + G_bb + G_ab + G_ba
            self.twopdm = (G_aa + G_bb + G_ab
                           + G_ab.permute(2, 3, 0, 1))[None]
        else:
            self.onepdm = torch.stack([rdm1_a, rdm1_b])
            self.twopdm = torch.stack([G_aa, G_bb, G_ab])
        self.e_tot = E
        self.optimized = True
        return self.onepdm, E

    def make_rdm2(self, Ham=None, **kwargs):
        return self.twopdm

    def run_dmet_ham(self, Ham, last_aabb=True, **kwargs):
        """Energy of the scaled DMET Hamiltonian with the stored RDMs."""
        r1, r2 = self.onepdm, self.twopdm
        dev = r1.device
        n = Ham.norb
        H1 = as_f64(Ham.H1["cd"], dev)
        H2 = Ham.H2["ccdd"]
        if self.ghf or Ham.restricted:
            E1 = (1.0 if self.ghf else 2.0) * torch.sum(H1[0] * r1[0])
            E2 = 0.5 * torch.sum(_s1_block(H2[0], n, dev) * r2[0])
        else:
            E1 = torch.sum(H1[0] * r1[0]) + torch.sum(H1[1] * r1[1])
            E2 = 0.5 * torch.sum(_s1_block(H2[0], n, dev) * r2[0]) \
                + 0.5 * torch.sum(_s1_block(H2[1], n, dev) * r2[1]) \
                + torch.sum(_s1_block(H2[2], n, dev) * r2[2])
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass


class MP2(CCSD):
    """MP2 solver through the same response-RDM machinery."""

    energy_fn = staticmethod(_e_tot_mp2)


class CCD(CCSD):
    """CCD: coupled cluster doubles (t1 pinned at zero; the adjoint is
    restricted to the t2 sector)."""

    freeze_t1 = True


# spin-flavored aliases
RCCSD = UCCSD = GCCSD = CCSD
UCCD = GCCD = CCD


class LCCSD(CCSD):
    """Approximate-lambda CCSD: amplitudes are full CCSD; the lambda
    (adjoint) solve is truncated to `lambda_sweeps` preconditioned
    Richardson sweeps, making the response RDMs cheaper and approximate to
    O(t^2)."""

    lambda_sweeps = 2

    def __init__(self, *args, lambda_sweeps=2, **kwargs):
        super().__init__(*args, **kwargs)
        self.lambda_sweeps = lambda_sweeps


class LCCD(LCCSD):
    """Approximate-lambda CCD."""
    freeze_t1 = True


class CCSD_ITE(CCSD):
    """CCSD with imaginary-time-evolution amplitude updates: same fixed
    point, damped unpreconditioned steps."""

    ite_dtau = 0.5

    def __init__(self, *args, ite_dtau=0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.ite_dtau = ite_dtau


class BCCSD(CCSD):
    """Brueckner coupled cluster: rotate the orbitals until the singles
    vanish, then CCSD response RDMs in the Brueckner basis.

    run() performs the Brueckner loop (orbital update by exp of the
    occ-virt T1 generator; the amplitude solves on the device, the n x n
    rotations on the host)."""

    def __init__(self, *args, bcc_tol=1e-6, bcc_max_cycle=20, **kwargs):
        super().__init__(*args, **kwargs)
        # the Brueckner loop rotates each spin's orbitals: a ghf flag is
        # ignored, as in the JAX package
        self.ghf = False
        self.bcc_tol = bcc_tol
        self.bcc_max_cycle = bcc_max_cycle

    def run(self, Ham, nelec=None, dm0=None, calc_rdm2=False, **kwargs):
        if nelec is None:
            raise ValueError("BCCSD.run requires nelec")
        Ca, Cb, na, nb = self._reference(Ham, nelec, dm0)
        Ca = np.array(Ca, copy=True)
        Cb = np.array(Cb, copy=True)
        nocc = na + nb
        n = Ham.norb

        h1a, h1b, g_aa, g_bb, g_ab = self._unpack(Ham)
        opts = (("tol", self.conv_tol), ("max_cycle", self.max_cycle),
                ("diis_space", self.diis_space))

        t1_max = np.inf
        for it in range(self.bcc_max_cycle):
            with torch.no_grad():
                h_so, g_chem = _mo_so_integrals(
                    (h1a, h1b), (g_aa, g_bb, g_ab), as_f64(Ca, self.device),
                    as_f64(Cb, self.device), na, nb)
                W = _antisymmetrize(g_chem)
                del g_chem
                t1, _, _ = _solve_amplitudes(h_so, W, nocc, **dict(opts))
            t1 = t1.cpu().numpy()
            t1_max = np.max(np.abs(t1))
            if t1_max < self.bcc_tol:
                break
            # spin-orbital order [occ_a, occ_b, vir_a, vir_b]: extract the
            # per-spin occ-virt blocks and rotate each set of orbitals
            t1a = t1[:na, :n - na]
            t1b = t1[na:nocc, n - na:]
            for C, t1s, no in ((Ca, t1a, na), (Cb, t1b, nb)):
                K = np.zeros((n, n))
                K[:no, no:] = -t1s
                K[no:, :no] = t1s.T
                C[:] = C @ sla.expm(K)
        else:
            log.warn("Brueckner loop not converged: max|t1| = %.2e", t1_max)
        log.info("BCCSD: Brueckner orbitals converged in %d rotations "
                 "(max|t1| = %.2e)", it, t1_max)
        return self._energy_rdms(Ham, Ca, Cb, na, nb, opts=opts)


class TCCSD(CCSD):
    """Tailored CCSD: the CAS-sector T1/T2 are read out of a CAS-FCI wave
    function (solvers/ci_to_cc.py) and frozen; the external amplitudes
    relax by CCSD.  CAS = the ncas canonical orbitals around the Fermi
    level of each spin channel (per-spin windows on unrestricted
    references, the UCASCI frame), solved by spin-dependent FCI on the
    device.  This is the static-correlation-safe CC for spin-polarized
    d-block embeddings where plain UCCSD stalls on the near-degenerate d
    manifold.  RDMs are response densities at fixed CAS amplitudes."""

    energy_fn = staticmethod(_e_tot_tcc)

    def __init__(self, ncas, nelecas, restricted=True, Sz=0, **kwargs):
        super().__init__(restricted=restricted, Sz=Sz, **kwargs)
        # the CAS windows are per spin: a ghf flag is ignored, as in the
        # JAX package
        self.ghf = False
        self.frozen = None
        self.ncas = ncas
        if isinstance(nelecas, (tuple, list)):
            self.na_cas, self.nb_cas = nelecas
            self.nelecas = self.na_cas + self.nb_cas
        else:
            self.nelecas = nelecas
            self.na_cas = nelecas // 2 + nelecas % 2
            self.nb_cas = nelecas - self.na_cas

    def run(self, Ham, nelec=None, dm0=None, calc_rdm2=False, **kwargs):
        from libdmet_preview_tpu_torch.solvers.casci import (
            _core_embed_uhf, _cas_eri_uhf)
        from libdmet_preview_tpu_torch.solvers.ci_to_cc import ci_to_cc_so
        from libdmet_preview_tpu_torch.solvers.fci import fci_kernel
        if nelec is None:
            raise ValueError("TCCSD.run requires nelec")
        Ca, Cb, na, nb = self._reference(Ham, nelec, dm0)
        n = Ham.norb
        nocc = na + nb
        dev = self.device

        # --- CAS-FCI in the per-spin canonical MO bases, core-veff
        # dressed (spin-dependent active Hamiltonian; restricted
        # references reduce to the same equations with Ca == Cb)
        ncas = self.ncas
        na_cas, nb_cas = self.na_cas, self.nb_cas
        nca, ncb = na - na_cas, nb - nb_cas
        log.eassert(nca >= 0 and ncb >= 0 and max(nca, ncb) + ncas <= n,
                    "TCCSD active window (%d, (%d,%d)) incompatible "
                    "with nelec=(%d,%d), norb=%d", ncas, na_cas, nb_cas,
                    na, nb, n)
        blocks = self._unpack(Ham)
        Cat, Cbt = as_f64(Ca, dev), as_f64(Cb, dev)
        with stage("TCC CAS transform", dev):
            h_a, h_b, _, _, _ = _core_embed_uhf(
                blocks, Cat[:, :nca], Cbt[:, :ncb], 0.0)
            Aa, Ab = Cat[:, nca:nca + ncas], Cbt[:, ncb:ncb + ncas]
            h_a, h_b = Aa.T @ h_a @ Aa, Ab.T @ h_b @ Ab
            g_cas_aa, g_cas_bb, g_cas_ab = _cas_eri_uhf(blocks[2:], Aa, Ab)
        with stage("TCC CAS FCI", dev):
            self.cas_counter = {"sigma": 0}
            _, ci = fci_kernel((h_a, h_b), (g_cas_aa, g_cas_ab, g_cas_bb),
                               ncas, (na_cas, nb_cas), ecore=0.0, tol=1e-12,
                               device=dev, counter=self.cas_counter)
        with stage("TCC CI to CC", dev):
            t1_cas, t2_cas = ci_to_cc_so(ci, ncas, (na_cas, nb_cas))

        # --- embed the CAS amplitudes into the full spin-orbital layout
        nva, nvb = n - na, n - nb
        occ_map = ([na - na_cas + i for i in range(na_cas)]
                   + [na + (nb - nb_cas) + i for i in range(nb_cas)])
        vir_map = ([i for i in range(ncas - na_cas)]
                   + [nva + i for i in range(ncas - nb_cas)])
        t1f = np.zeros((nocc, nva + nvb))
        m1 = np.zeros_like(t1f)
        t1f[np.ix_(occ_map, vir_map)] = t1_cas
        m1[np.ix_(occ_map, vir_map)] = 1.0
        t2f = torch.zeros((nocc, nocc, nva + nvb, nva + nvb),
                          dtype=torch.float64, device=dev)
        m2 = torch.zeros_like(t2f)
        ix = [torch.as_tensor(a, device=dev)
              for a in np.ix_(occ_map, occ_map, vir_map, vir_map)]
        t2f[ix[0], ix[1], ix[2], ix[3]] = as_f64(t2_cas, dev)
        m2[ix[0], ix[1], ix[2], ix[3]] = 1.0
        # the masks and the frozen CAS amplitudes of the last run
        self.frozen = (as_f64(m1, dev), as_f64(t1f, dev), m2, t2f)
        return self._energy_rdms(Ham, Ca, Cb, na, nb, extra=self.frozen)


UTCCSD = GTCCSD = TCCSD
