"""
Correlation-potential fitting (PyTorch port of
libdmet_preview_tpu/ops/fit.py: the vcor helpers, get_dV_dparam, the
zero-T objective with its analytic gradient, the CG and LM engines,
minimize_cg / minimize, the active-space projectors, FitVcorEmb,
FitVcorFull, FitVcorTwoStep and cvx_frac).

FitVcorEmb minimizes || rho_mf(param) - rho_corr ||_F over the embedding
space.  The objective -- assemble V_emb from the parameter vector,
generalized eigh, zero-T occupation, density build, residual -- is tensor
math on the lattice's device, batched over spin; the zero-T gradient is
the analytic occ-virt first-order perturbation formula, the finite-T one
comes from autograd through zlinalg.rho_fermi_real.

The JAX package runs each engine as one lax.while_loop program.  PyTorch
runs eagerly, so here each engine is a Python loop over tensor math on the
caller's device: the tensor work stays on the device, and every
accept/reject or stop decision reads its operands to the host once (one
host read per decision).  Every constant and every stopping rule of the
JAX engines is kept, so both packages take the same path and land on the
same parameters.

The whole-lattice stage (FitVcorFull) re-solves the lattice mean field at
every evaluation: at finite beta with a local vcor the whole cost (lattice
Fock + vcor, one global-mu Fermi density over the (spin x k) batch through
zlinalg.zrho_fermi, embedding fold, masked residual) is one differentiable
tensor function on the lattice's device, and its gradient comes from
backward() through the Daleckii-Krein backward of zrho_fermi.
"""

import copy

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import Iterable, as_f64
from libdmet_preview_tpu_torch.utils.timer import stage, to_host
from libdmet_preview_tpu_torch.ops import embham
from libdmet_preview_tpu_torch.ops import zlinalg as _zl


# ----------------------------------------------------------------------
# vcor helpers
# ----------------------------------------------------------------------

def addDiag(v, val, idx_range=None):
    rep = v.get()
    spin = rep.shape[0]
    if not isinstance(val, Iterable):
        val = [val] * spin
    if idx_range is None:
        idx_range = getattr(v, "idx_range", list(range(rep.shape[-1])))
    rep = np.array(rep, copy=True)
    for s in range(min(spin, 2)):
        rep[s, idx_range, idx_range] += val[s]
    v.assign(rep)
    return v


def vcor_diag_average(v, idx_range=None):
    rep = v.get()
    if idx_range is None:
        idx_range = getattr(v, "idx_range", list(range(rep.shape[-1])))
    return np.average(rep[:, idx_range, idx_range], axis=1)


def keep_vcor_trace_fixed(v_new, v_old):
    """GSO/Bogoliubov trace fix: remove the mu-absorbable drift -- an EQUAL
    diagonal shift on va and vb maps to -mu_matrix in the combined GSO
    frame -- by subtracting 0.5*(avg diag dva - avg diag dvb) from both
    normal diagonals."""
    dv = np.asarray(v_new.get()) - np.asarray(v_old.get())
    d = 0.5 * (np.average(np.diagonal(dv[0]))
               - np.average(np.diagonal(dv[1])))
    addDiag(v_new, -d)
    return v_new


def make_vcor_trace_unchanged(v_new, v_old, idx_range=None):
    v_mat_old = v_old.get()
    v_mat_new = v_new.get()
    if idx_range is None:
        idx_range = getattr(v_new, "idx_range",
                            list(range(v_mat_new.shape[-1])))
    dv_ave = np.average((v_mat_new - v_mat_old)[:, idx_range, idx_range],
                        axis=1)
    addDiag(v_new, -dv_ave, idx_range=idx_range)
    return v_new


# ----------------------------------------------------------------------
# dV/dparam in the embedding basis
# ----------------------------------------------------------------------

def get_dV_dparam(vcor, basis, basis_k=None, kmesh=None):
    """dV_emb/dparam, dense (nparam, spin, neo, neo) tensor on the basis'
    device.  basis: (spin, ncells, nlo, neo) R-space tensor."""
    if vcor.islocal():
        grad = as_f64(vcor.gradient()[:, :basis.shape[0]], basis.device)
        return torch.einsum("sRpi, Pspq, sRqj -> Psij", basis, grad, basis)
    # non-local: per-parameter translation-invariant stripes through k space
    from libdmet_preview_tpu_torch.ops import fourier
    spin = basis.shape[0]
    gradR = vcor.gradient_R()[:, :spin]      # (P, spin, ncells, n, n)
    g_re, g_im = fourier.R2k(gradR, tuple(int(x) for x in kmesh))
    g = torch.complex(as_f64(g_re, basis.device), as_f64(g_im, basis.device))
    if basis_k is None:
        basis_k = fourier.R2k(basis, tuple(int(x) for x in kmesh))
    b = torch.complex(basis_k[0], basis_k[1])            # (spin, nk, n, neo)
    vb = torch.einsum("Pskpq, skqj -> Pskpj", g, b)
    dV = torch.einsum("skpi, Pskpj -> Psij", b.conj(), vb)
    return dV.real / gradR.shape[2]


# ----------------------------------------------------------------------
# zero-T objective and gradient
# ----------------------------------------------------------------------

def _nelec_column(nelec, device):
    """Per-spin occupation counts as a (spin, 1) long tensor; a tensor is
    taken as it is, so a caller that evaluates many times converts once."""
    if isinstance(nelec, torch.Tensor):
        return nelec
    return torch.as_tensor(nelec, dtype=torch.long, device=device)[:, None]


def _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask, nelec, thr_deg=1e-3):
    """Return (rho1_masked, ew, ev_orth, ewocc) for the current parameters.

    Generalized eigenproblem handled by the Cholesky congruence
    L^-1 H L^-H; for orthonormal embedding bases L = I.
    nelec: per-spin occupation tuple (or _nelec_column's tensor)."""
    Li = ovlp_chol_inv
    Heff = embH1 + torch.einsum("P, Psij -> sij", param, dV)
    Horth = Li @ Heff @ Li.transpose(-1, -2)
    ew, ev = torch.linalg.eigh(Horth)

    ne = _nelec_column(nelec, ew.device)                        # (spin, 1)
    # a full space (ne == neo, a whole-lattice impurity) takes the top
    # level for both, as the JAX package's clamped index does
    top = torch.clamp(ne, max=ew.shape[-1] - 1)
    mu = 0.5 * (torch.gather(ew, 1, ne - 1) + torch.gather(ew, 1, top))
    below = (ew < mu - thr_deg).to(ew.dtype)
    deg = (torch.abs(ew - mu) <= thr_deg).to(ew.dtype)
    ndeg = torch.sum(deg, dim=1, keepdim=True)
    nrem = ne - torch.sum(below, dim=1, keepdim=True)
    frac = torch.where(ndeg > 0, nrem / torch.clamp(ndeg, min=1.0),
                       torch.zeros_like(ndeg))
    ewocc = below + frac * deg
    rho_orth = (ev * ewocc[:, None, :]) @ ev.transpose(-1, -2)
    # back to the original (non-orthogonal) basis: C = Li^T C'
    rho1 = Li.transpose(-1, -2) @ rho_orth @ Li
    return rho1 * fit_mask, ew, ev, ewocc


def _fit_err(param, embH1, dV, ovlp_chol_inv, fit_mask, rho_target, nelec,
             thr_deg=1e-3):
    spin = embH1.shape[0]
    rho1, _, _, _ = _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask, nelec,
                             thr_deg)
    return torch.linalg.norm(rho1 - rho_target) / np.sqrt(1.0 * spin)


def _fit_err_grad(param, embH1, dV, ovlp_chol_inv, fit_mask, rho_target,
                  nelec, thr_deg=1e-3):
    """Analytic zero-T gradient via occ-virt perturbation theory, batched
    over spin.  Returns (err, grad) tensors."""
    spin = embH1.shape[0]
    neo = embH1.shape[-1]
    rho1, ew, ev, ewocc = _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask,
                                   nelec, thr_deg)
    drho = rho1 - rho_target
    val = torch.linalg.norm(drho)
    val_safe = torch.clamp(val, min=1e-30)

    Li = ovlp_chol_inv
    # chain rule through rho_orig = Li^T rho_orth Li:
    # dw/drho_orth = Li (dw/drho_orig) Li^T
    D = Li @ drho @ Li.transpose(-1, -2)
    # 1 / (e_occ[n] - e_virt[m]) on the (virt m, occ n) pairs, 0 elsewhere
    ne = _nelec_column(nelec, ew.device)
    is_occ = torch.arange(neo, device=ew.device)[None, :] < ne   # (spin, n)
    pair = (~is_occ)[:, :, None] & is_occ[:, None, :]
    diff = ew[:, None, :] - ew[:, :, None]
    e_mn = torch.where(pair, 1.0 / torch.where(pair, diff,
                                               torch.ones_like(diff)),
                       torch.zeros_like(diff))
    temp = (ev.transpose(-1, -2) @ D @ ev) * e_mn \
        / (val_safe * np.sqrt(1.0 * spin))
    A = ev @ temp @ ev.transpose(-1, -2)
    G = A + A.transpose(-1, -2)
    # transform back through the congruence: dH_orth = Li dH Li^T
    # => dw/dH = Li^T G_orth Li
    G = Li.transpose(-1, -2) @ G @ Li
    grad = torch.einsum("Psij, sij -> P", dV, G)
    return val / np.sqrt(1.0 * spin), grad


# ----------------------------------------------------------------------
# device optimizers
# ----------------------------------------------------------------------

def _cg_engine(fg, x0, max_iter, ytol, gtol, dx_tol=1e-7):
    """Polak-Ribiere CG with backtracking-Armijo search.
    fg: x -> (f, grad) tensors.  Returns (x, f, max|g|) tensors.
    _cg_engine.steps counts the CG steps taken since the caller last set
    it to 0."""
    f, g = fg(x0)
    x = x0
    d = -g
    step0 = 1.0
    n_small = 0
    done = to_host(torch.max(torch.abs(g)), float) < gtol * 0.1
    it = 0
    while not done and it < max_iter:
        with stage("cg step", x.device):
            dg0 = torch.dot(g, d)
            d = torch.where(dg0 >= 0, -g, d)
            dg = torch.where(dg0 >= 0, -torch.dot(g, g), dg0)

            # Armijo 1e-4, alpha * 0.4 per rejection, at most 30 trials
            alpha = step0
            f_new, g_new = f, g
            found = False
            for _ in range(30):
                f_try, g_try = fg(x + alpha * d)
                if to_host(f_try <= f + 1e-4 * alpha * dg, bool):
                    f_new, g_new = f_try, g_try
                    found = True
                    break
                alpha = alpha * 0.4

            step0 = min(max(alpha * 2.5, 1e-4), 1.0)
            dx = torch.max(torch.abs(alpha * d)) if d.numel() else \
                torch.zeros((), dtype=x.dtype, device=x.device)
            beta_pr = torch.clamp(torch.dot(g_new, g_new - g)
                                  / torch.clamp(torch.dot(g, g), min=1e-30),
                                  min=0.0)
            d_new = -g_new + beta_pr * d
            df, dx_h, gmax = to_host(torch.stack(
                [f - f_new, dx, torch.max(torch.abs(g_new))]),
                torch.Tensor.tolist)
            n_small = n_small + 1 if df < ytol else 0
            done = (not found) or n_small >= 2 or dx_h < dx_tol \
                or gmax < gtol * 0.1
            if found:
                x = x + alpha * d
                f, g, d = f_new, g_new, d_new
            it += 1
    _cg_engine.steps += it
    return x, f, torch.max(torch.abs(g))


_cg_engine.steps = 0


def _lm_engine_ft(p0, embH1, dV_emb, target, nelec2, beta, max_iter,
                  ytol, gtol, lam0=1e-3):
    """Finite-T embedding vcor fit by Levenberg-Marquardt with the exact
    Daleckii-Krein Jacobian: in the eigenbasis of Heff the derivative of
    the Fermi density along dV_P is

      J_P = K o M_P - dmu_P diag(f'),   M_P = V^T dV_P V,
      dmu_P = sum_i f'_i (M_P)_ii / sum_i f'_i          [dN = 0]

    so all P directions share one eigh per iteration.  nelec2 is the
    doubled-spectrum count.  Returns (p, err, max|grad err|)."""
    spin = embH1.shape[0]
    n = embH1.shape[-1]
    P = p0.shape[0]
    half = 0.5 * float(nelec2)

    def state(p):
        """(err, J (P, spin*n*n), r (spin*n*n)) at p; one eigh/spin."""
        Heff = embH1 + torch.einsum("P, Psij -> sij", p, dV_emb)
        errs = 0.0
        Js, rs = [], []
        for s in range(spin):
            ew, V = torch.linalg.eigh(Heff[s])
            mu = _zl._bisect_mu(ew, half, beta)
            occ = _zl._fermi(ew, mu, beta)
            tt = V.T @ target[s] @ V
            r = torch.diag(occ) - tt
            f, K = _zl._fermi_K(ew, mu, beta)
            fp = -beta * f * (1.0 - f)
            denom = torch.sum(fp)
            safe = torch.abs(denom) > 1e-300
            inv_den = torch.where(
                safe, 1.0 / torch.where(safe, denom, torch.ones_like(denom)),
                torch.zeros_like(denom))
            M = V.T @ dV_emb[:, s] @ V                       # (P, n, n)
            dmu = torch.einsum("Pii, i -> P", M, fp) * inv_den
            J = K[None] * M - dmu[:, None, None] * torch.diag(fp)[None]
            Js.append(J.reshape(P, n * n))
            rs.append(r.reshape(n * n))
            errs = errs + torch.sum(r * r)
        err = torch.sqrt(errs / spin)
        return err, torch.cat(Js, dim=1), torch.cat(rs)

    return _lm_loop(state, p0, spin, max_iter, ytol, gtol, lam0)


def _lm_loop(state, p0, spin, max_iter, ytol, gtol, lam0=1e-3):
    """The LM accept/reject loop.
    state: p -> (err, J (P, m), r (m,)) with err = sqrt(r.r / spin);
    grad err = J r / (err spin).

    As in the JAX package, a REJECTED step also counts toward n_small
    (two rejections in a row stop the fit)."""
    P = p0.shape[0]
    eyeP = torch.eye(P, dtype=p0.dtype, device=p0.device)

    def grad(err, J, r):
        return (J @ r) / torch.clamp(err * spin, min=1e-300)

    p = p0
    err, J, r = state(p0)
    err_h, gmax_h = to_host(torch.stack(
        [err, torch.max(torch.abs(grad(err, J, r)))]), torch.Tensor.tolist)
    done = gmax_h < gtol * 0.1
    lam = lam0
    n_small = 0
    it = 0
    while not done and it < max_iter:
        A = J @ J.T
        Ad = A + lam * torch.diag(torch.diag(A)) \
            + (1e-10 * torch.trace(A) / P + 1e-30) * eyeP
        dp = torch.linalg.solve(Ad, -(J @ r))
        p_try = p + dp
        err_t, J_t, r_t = state(p_try)
        err_t_h, gmax_t_h = to_host(torch.stack(
            [err_t, torch.max(torch.abs(grad(err_t, J_t, r_t)))]),
            torch.Tensor.tolist)
        ok = err_t_h < err_h
        if ok:
            df = err_h - err_t_h
            p, err, J, r = p_try, err_t, J_t, r_t
            err_h, gmax_h = err_t_h, gmax_t_h
            lam = max(lam / 3.0, 1e-12)
        else:
            df = 0.0
            lam = lam * 8.0
        n_small = n_small + 1 if df < ytol else 0
        done = n_small >= 2 or gmax_h < gtol * 0.1 or lam > 1e8
        it += 1
    return p, err, torch.max(torch.abs(grad(err, J, r)))


def _fit_lm_finite_t(p0, embH1, dV, Li, mask, target, ytol, gtol, nelec2,
                     beta, max_iter, spin):
    """Finite-T FitVcorEmb objective (overlap-Cholesky rotation Li +
    residual mask, identical to _fit_cg_finite_t) minimized by LM with
    the exact Daleckii-Krein Jacobian.  With W = Li[s]^T V the chain
    rule collapses to batched matmuls shared across all P directions:

      M_P = W^T dV_P W,
      dRho1_P = mask o (W (K o M_P - dmu_P diag f') W^T).
    """
    n = embH1.shape[-1]
    P = p0.shape[0]

    def state(p):
        Heff = embH1 + torch.einsum("P, Psij -> sij", p, dV)
        Horth = Li @ Heff @ Li.transpose(-1, -2)
        errs = 0.0
        Js, rs = [], []
        for s in range(spin):
            ew, V = torch.linalg.eigh(Horth[s])
            mu = _zl._bisect_mu(ew, 0.5 * nelec2[s], beta)
            occ = _zl._fermi(ew, mu, beta)
            W = Li[s].T @ V
            rho1 = (W * occ[None, :]) @ W.T
            d = rho1 * mask[s] - target[s]
            f, K = _zl._fermi_K(ew, mu, beta)
            fp = -beta * f * (1.0 - f)
            denom = torch.sum(fp)
            safe = torch.abs(denom) > 1e-300
            inv_den = torch.where(
                safe, 1.0 / torch.where(safe, denom, torch.ones_like(denom)),
                torch.zeros_like(denom))
            M = W.T @ dV[:, s] @ W                            # (P, n, n)
            dmu = torch.einsum("Pii, i -> P", M, fp) * inv_den
            core = K[None] * M - dmu[:, None, None] * torch.diag(fp)[None]
            J = (W @ core @ W.T) * mask[s][None]
            Js.append(J.reshape(P, n * n))
            rs.append(d.reshape(n * n))
            errs = errs + torch.sum(d * d)
        err = torch.sqrt(errs / spin)
        return err, torch.cat(Js, dim=1), torch.cat(rs)

    return _lm_loop(state, p0, spin, max_iter, ytol, gtol)


def _fit_cg_zero_t(p0, embH1, dV, Li, mask, target, ytol, gtol, nelec,
                   thr_deg, max_iter):
    def fg(p):
        return _fit_err_grad(p, embH1, dV, Li, mask, target, nelec=nelec,
                             thr_deg=thr_deg)
    return _cg_engine(fg, p0, max_iter, ytol, gtol)


def _err_finite_t(p, embH1, dV, Li, mask, target, nelec2, beta, spin,
                  C_act=None, tgt_act=None):
    """The finite-T FitVcorEmb objective, differentiable in p through
    zlinalg.rho_fermi_real: the masked residual, or with C_act the
    residual C^T rho1 C - tgt_act over the active embedding columns."""
    Heff = embH1 + torch.einsum("P, Psij -> sij", p, dV)
    Horth = Li @ Heff @ Li.transpose(-1, -2)
    errs = 0.0
    for s in range(spin):
        r_re, _ = _zl.rho_fermi_real(Horth[s], nelec2[s], beta)
        rho1 = Li[s].T @ r_re @ Li[s]
        if C_act is not None:
            d = C_act[s].T @ rho1 @ C_act[s] - tgt_act[s]
        else:
            d = rho1 * mask[s] - target[s]
        errs = errs + torch.sum(d ** 2)
    return torch.sqrt(errs / spin)


def _value_and_grad(err):
    """x -> (err(x), d err / dx), detached tensors."""
    def fg(x):
        x = x.detach().requires_grad_(True)
        e = err(x)
        (g,) = torch.autograd.grad(e, x)
        return e.detach(), g
    return fg


def _fit_cg_finite_t(p0, embH1, dV, Li, mask, target, ytol, gtol, nelec2,
                     beta, max_iter, spin):
    fg = _value_and_grad(lambda p: _err_finite_t(
        p, embH1, dV, Li, mask, target, nelec2, beta, spin))
    return _cg_engine(fg, p0, max_iter, ytol, gtol)


# ----------------------------------------------------------------------
# host optimizers: CG with ytol/gtol stopping, and the dispatcher
# ----------------------------------------------------------------------

def minimize_cg(fun_grad, x0, max_iter=300, ytol=1e-7, gtol=1e-3,
                dx_tol=1e-7):
    """Polak-Ribiere CG with backtracking-Armijo line search over a host
    objective fun_grad(x) -> (f, grad)."""
    x = np.asarray(x0, dtype=float).copy()
    f, g = fun_grad(x)
    d = -g
    n_small = 0
    step0 = 1.0
    for it in range(max_iter):
        gnorm = np.max(np.abs(g))
        if gnorm < gtol * 0.1:
            break
        # line search
        dg = np.dot(g, d)
        if dg >= 0:
            d = -g
            dg = -np.dot(g, g)
        alpha = step0
        f_new, g_new = None, None
        for _ in range(30):
            x_new = x + alpha * d
            f_try, g_try = fun_grad(x_new)
            if f_try <= f + 1e-4 * alpha * dg:
                f_new, g_new = f_try, g_try
                break
            alpha *= 0.4
        if f_new is None:
            break
        step0 = min(max(alpha * 2.5, 1e-4), 1.0)
        dx = np.max(np.abs(alpha * d)) if d.size else 0.0
        beta = max(0.0, np.dot(g_new, g_new - g) / max(np.dot(g, g), 1e-30))
        d = -g_new + beta * d
        df = f - f_new
        x, f, g = x_new, f_new, g_new
        if df < ytol:
            n_small += 1
            if n_small >= 2:
                break
        else:
            n_small = 0
        if dx < dx_tol:
            break
    return x, f, np.max(np.abs(g))


def minimize(fun_grad, x0, method="CG", max_iter=300, **kwargs):
    """Optimizer dispatcher over a host objective fun_grad(x) -> (f, grad):
    'CG' is minimize_cg; 'BFGS' / 'trust-ncg' map to scipy; 'SD' is plain
    steepest descent; 'AH' is the trust-region Newton-CG of
    _minimize_ah."""
    method = method.upper()
    if method == "CG":
        x, f, _ = minimize_cg(fun_grad, x0, max_iter=max_iter, **kwargs)
        return x, f
    if method in ("BFGS", "TRUST-NCG", "TRUSTNCG"):
        from scipy import optimize as opt
        name = "BFGS" if method == "BFGS" else "trust-ncg"
        extra = {}
        if name == "trust-ncg":
            # scipy requires a hessp for trust-ncg: finite-difference on
            # the gradient
            def hessp(x, p):
                eps = 1e-6
                g1 = fun_grad(np.asarray(x) + eps * np.asarray(p))[1]
                g0 = fun_grad(np.asarray(x))[1]
                return (np.asarray(g1) - np.asarray(g0)) / eps
            extra["hessp"] = hessp
        options = {"maxiter": max_iter}
        if "gtol" in kwargs:
            options["gtol"] = kwargs["gtol"]
        res = opt.minimize(lambda x: fun_grad(x)[0], np.asarray(x0),
                           jac=lambda x: np.asarray(fun_grad(x)[1]),
                           method=name, options=options, **extra)
        return np.asarray(res.x), float(res.fun)
    if method in ("AH", "NEWTON", "NEWTON-CG"):
        return _minimize_ah(fun_grad, x0, max_iter, **kwargs)
    if method == "SD":
        x = np.array(x0, dtype=float)
        step = kwargs.get("step", 0.1)
        f_old = None
        for _ in range(max_iter):
            f, g = fun_grad(x)
            f = float(f)
            if f_old is not None and abs(f - f_old) < kwargs.get(
                    "ytol", 1e-9):
                break
            x = x - step * np.asarray(g)
            f_old = f
        f, _ = fun_grad(x)
        return x, float(f)
    raise ValueError("unknown method %s" % method)


def _minimize_ah(fun_grad, x0, max_iter, hvp=None, trust_radius=0.5,
                 ytol=1e-10, gtol=1e-6, **kwargs):
    """Second-order minimizer: trust-region Newton steps with
    Hessian-VECTOR products only (truncated Steihaug CG inside the
    radius).  hvp(x, p) -> H p is used when given (for a torch objective,
    torch.autograd.functional.jvp through its gradient, or a double
    backward); otherwise forward differences on fun_grad."""
    x = np.array(x0, dtype=float)
    tr = trust_radius
    f, g = fun_grad(x)
    f = float(f)
    for _ in range(max_iter):
        gn = np.asarray(g)
        if np.max(np.abs(gn)) < gtol:
            break

        if hvp is None:
            def hv(p, _x=x, _g=gn):
                eps = 1e-6 / max(np.linalg.norm(p), 1e-30)
                g1 = np.asarray(fun_grad(_x + eps * p)[1])
                return (g1 - _g) / eps
        else:
            def hv(p, _x=x):
                return np.asarray(hvp(_x, p))

        def to_boundary(d, p):
            return d + (tr - np.linalg.norm(d)) \
                / max(np.linalg.norm(p), 1e-30) * p

        # truncated CG (Steihaug): solve H d = -g within the radius
        d = np.zeros_like(x)
        r = gn.copy()
        p = -r
        rs = float(r @ r)
        for _ in range(min(len(x), 50)):
            Hp = hv(p)
            pHp = float(p @ Hp)
            if pHp <= 1e-14 * float(p @ p):
                d = to_boundary(d, p)       # negative curvature
                break
            alpha = rs / pHp
            d_new = d + alpha * p
            if np.linalg.norm(d_new) > tr:
                d = to_boundary(d, p)
                break
            d = d_new
            r = r + alpha * Hp
            rs_new = float(r @ r)
            if rs_new < 1e-18:
                break
            p = -r + (rs_new / rs) * p
            rs = rs_new

        f_new, g_new = fun_grad(x + d)
        f_new = float(f_new)
        pred = -float(gn @ d) - 0.5 * float(d @ hv(d))
        rho = (f - f_new) / max(pred, 1e-30)
        if f_new < f:
            x = x + d
            df = f - f_new
            f, g = f_new, g_new
            if rho > 0.75 and np.linalg.norm(d) > 0.8 * tr:
                tr = min(tr * 2.0, 10.0)
            if df < ytol:
                break
        else:
            tr *= 0.25
            if tr < 1e-10:
                break
    return x, float(f)


# ----------------------------------------------------------------------
# active-space projectors (host NumPy on the supercell LO density)
# ----------------------------------------------------------------------

def get_active_projector(act_idx, rdm1, tol=1e-9):
    """Active-space projector from selected LOs: span of the occupied and
    virtual components of the chosen columns,

      P_occ = rho[:, act],  P_virt = (I - rho)[:, act],

    each orthonormalized after dropping singular directions.

    act_idx: LO indices; rdm1: (spin, nsites, nsites) real supercell LO
    density in the PER-SPIN convention (restricted occupations <= 1, as
    returned by mfd.HF).  Returns (P (spin, nsites, nact'), nocc (spin,))
    with nocc the number of occupied-derived columns per spin."""
    act_idx = np.asarray(act_idx, dtype=int)
    rdm1 = np.asarray(rdm1)
    if rdm1.ndim == 2:
        rdm1 = rdm1[None]
    nsites = rdm1.shape[-1]
    Ps, nocc = [], []
    for r in rdm1:
        cols = []
        for block in (r[:, act_idx], (np.eye(nsites) - r)[:, act_idx]):
            ew, ev = np.linalg.eigh(block.T @ block)
            X = block @ ev[:, ew > tol]
            if X.shape[-1]:
                # Lowdin orthonormalization
                w, V = np.linalg.eigh(X.T @ X)
                X = X @ (V / np.sqrt(w)) @ V.T
            cols.append(X)
        Ps.append(np.hstack(cols))
        nocc.append(cols[0].shape[-1])
    return np.asarray(Ps), np.asarray(nocc, dtype=int)


def make_rdm1_P(fock, vcor_mat, P, nocc, project_back=True):
    """Mean-field density of the ACTIVE-projected problem P^T (F + u) P.

    fock: (spin, nsites, nsites); vcor_mat: (spin, nsites, nsites) or
    None; P: (spin, nsites, nact); nocc: per-spin occupation counts.
    Returns the PER-SPIN rdm1, projected back to the full LO space when
    project_back."""
    fock = np.asarray(fock)
    if fock.ndim == 2:
        fock = fock[None]
    out = []
    for s in range(fock.shape[0]):
        F = fock[s]
        if vcor_mat is not None:
            F = F + np.asarray(vcor_mat)[s]
        ew, ev = np.linalg.eigh(P[s].T @ F @ P[s])
        C = ev[:, :int(nocc[s])]
        r = C @ C.T
        if project_back:
            r = P[s] @ r @ P[s].T
        out.append(r)
    return np.asarray(out)


def get_active_projector_full(P):
    """Full-space projection operator P P^T per spin (orthonormal LOs)."""
    P = np.asarray(P)
    return np.einsum("spi, sqi -> spq", P, P)


# ----------------------------------------------------------------------
# the fit in the fixed embedding basis
# ----------------------------------------------------------------------

def FitVcorEmb(rho, lattice, basis, vcor, beta, MaxIter=300, imp_fit=False,
               imp_idx=None, det=False, det_idx=None, CG_check=False,
               BFGS=False, **kwargs):
    """Fit vcor in the fixed embedding basis, on the basis' device.

    rho: (spin, neo, neo) correlated embedding rdm1 (tensor or array);
    basis: (spin, ncells, nlo, neo) tensor.  method="CG" (default) runs
    the CG engine, method="LM" the Levenberg-Marquardt engine at finite
    beta (CG at beta = inf, as in the JAX package); any other method goes
    through minimize.  P_act (spin, nsites, nact) restricts the vcor
    response to an active subspace; C_act (spin, neo, nact) measures the
    residual over active embedding columns (host-driven CG, through the
    Fermi op at beta = 1e6 when beta = inf).
    Returns (vcor, err_begin, err_end)."""
    dev = basis.device
    spin = basis.shape[0]
    neo = basis.shape[-1]
    basis_k = lattice.R2k_basis(basis)

    nelec = kwargs.get("nelec", None)
    if nelec is None:
        ne = lattice.ncore + lattice.nval
        nelec = (ne,) * spin
    elif not isinstance(nelec, Iterable):
        nelec = (int(nelec),) * spin
    else:
        nelec = tuple(int(x) for x in nelec)
    thr_deg = float(kwargs.get("tol_deg", 1e-3))

    if lattice.use_hcore_as_emb_ham:
        fock_k = lattice.getH1(kspace=True)
    else:
        fock_k = lattice.getFock(kspace=True)
    ovlp_k = lattice.get_ovlp(kspace=True)

    embH1 = embham.transform_h1(fock_k, basis_k)
    vcor_mat = kwargs.get("vcor_mat", None)
    if vcor_mat is not None:
        embH1 = embH1 + as_f64(vcor_mat, dev)
    ovlp_emb = embham.transform_h1(ovlp_k, basis_k)

    # inverse Cholesky factor of the embedding overlap (identity for
    # orthonormal LOs)
    Li = torch.linalg.inv(torch.linalg.cholesky(ovlp_emb))

    P_act = kwargs.get("P_act", None)
    if P_act is not None:
        # restrict the vcor response to the active subspace: project the
        # embedding basis by P P^T before building dV/dparam
        P_full = as_f64(get_active_projector_full(P_act), dev)
        if P_full.shape[0] == 1 and spin == 2:
            P_full = P_full.expand(2, -1, -1)
        bP = (P_full @ basis.reshape(spin, -1, neo)).reshape(basis.shape)
        dV = get_dV_dparam(vcor, bP, basis_k=lattice.R2k_basis(bP),
                           kmesh=lattice.kmesh)
    else:
        dV = get_dV_dparam(vcor, basis, basis_k=basis_k, kmesh=lattice.kmesh)

    # fit index mask (imp_fit / det options)
    if imp_fit:
        imp_idx, det_idx = list(range(lattice.nimp)), []
    elif det:
        imp_idx, det_idx = [], list(range(lattice.nimp))
    elif imp_idx is None:
        if det_idx is None:
            imp_idx, det_idx = list(range(neo)), []
        else:
            imp_idx = []
    elif det_idx is None:
        det_idx = []
    mask = np.zeros((spin, neo, neo))
    ii = np.asarray(imp_idx, dtype=int)
    if ii.size:
        mask[np.ix_(range(spin), ii, ii)] = 1.0
    dd = np.asarray(det_idx, dtype=int)
    if dd.size:
        mask[:, dd, dd] = 1.0
    mask = as_f64(mask, dev)

    rho = as_f64(rho, dev)
    if kwargs.get("idem_fit", False):
        # fit against the idempotent part of the correlated rdm1: occupy
        # its natural orbitals with assignocc (host, tiny)
        from libdmet_preview_tpu_torch.ops import mfd
        rho_h = to_host(rho)
        rho_idem = np.empty_like(rho_h)
        for s in range(spin):
            ew, ev = np.linalg.eigh(rho_h[s])
            ew, ev = -ew[::-1], ev[:, ::-1]
            ewocc, _, _ = mfd.assignocc(ew, int(nelec[s]), beta, mu0=-0.5)
            rho_idem[s] = (ev * ewocc) @ ev.T
        rho = as_f64(rho_idem, dev)
    rho_target = rho * mask

    args = (embH1, dV, Li, mask, rho_target)
    nelec_t = _nelec_column(nelec, dev)
    nelec2 = tuple(2 * int(x) for x in nelec)  # doubled spectrum

    C_act = kwargs.get("C_act", None)
    tgt_act = None
    if C_act is not None:
        # active-space residual: || C^T (rho1 - rho) C || over the active
        # embedding columns.  The closed-form zero-T gradient has no
        # projected-residual variant; a large effective beta through the
        # degenerate-safe Fermi op is exact for any gapped embedding
        # spectrum
        if beta == np.inf:
            beta = 1e6
        C_act = as_f64(C_act, dev)
        if C_act.ndim == 2:
            C_act = C_act[None]
        if C_act.shape[0] == 1 and spin == 2:
            C_act = C_act.expand(2, -1, -1)
        tgt_act = C_act.transpose(-1, -2) @ rho @ C_act

    if beta < np.inf:
        # finite temperature: differentiate straight through the
        # degenerate-safe Fermi-density op
        fg_dev = _value_and_grad(lambda p: _err_finite_t(
            p, *args, nelec2, float(beta), spin, C_act, tgt_act))
    else:
        def fg_dev(p):
            return _fit_err_grad(p, *args, nelec=nelec_t, thr_deg=thr_deg)

    def fun_grad(p):
        e, g = fg_dev(as_f64(p, dev))
        return to_host(e, float), to_host(g)

    err_begin = fun_grad(vcor.param)[0]
    if kwargs.get("test_grad", False):
        _test_grad(vcor.param, fun_grad)

    method = kwargs.get("method", "CG").upper()
    ytol = kwargs.get("ytol", 1e-7)
    gtol = kwargs.get("gtol", 1e-3)
    if method in ("CG", "LM") and C_act is not None:
        # the device engines bake in the mask residual; active-space
        # residuals go through the host-driven CG
        x, err_end, gnorm = minimize_cg(fun_grad, vcor.param,
                                        max_iter=MaxIter, ytol=ytol,
                                        gtol=gtol)
        x, err_end, gnorm = np.asarray(x), float(err_end), float(gnorm)
    elif method in ("CG", "LM"):
        p0 = as_f64(vcor.param, dev)
        if beta < np.inf and method == "LM":
            x, err_end, gnorm = _fit_lm_finite_t(
                p0, *args, ytol, gtol, nelec2, float(beta), int(MaxIter),
                spin)
        elif beta < np.inf:
            x, err_end, gnorm = _fit_cg_finite_t(
                p0, *args, ytol, gtol, nelec2, float(beta), int(MaxIter),
                spin)
        else:
            x, err_end, gnorm = _fit_cg_zero_t(
                p0, *args, ytol, gtol, nelec_t, thr_deg, int(MaxIter))
        x, err_end, gnorm = (to_host(x), to_host(err_end, float),
                             to_host(gnorm, float))
    else:
        x, err_end = minimize(fun_grad, vcor.param, method=method,
                              max_iter=MaxIter)
        gnorm = float(np.max(np.abs(fun_grad(x)[1])))

    if CG_check or BFGS or gnorm > 1e-3:
        from scipy import optimize as opt
        res = opt.minimize(lambda p: fun_grad(p)[0], x,
                           jac=lambda p: fun_grad(p)[1],
                           method="BFGS" if BFGS else "CG",
                           options={"maxiter": min(len(x) * 10, MaxIter),
                                    "gtol": max(gnorm * 0.1, 5e-5)})
        if res.fun < err_end:
            x, err_end = res.x, float(res.fun)

    vcor.update(x)
    log.info("FitVcorEmb: err %20.12f -> %20.12f (|g|=%.2e)",
             err_begin, err_end, gnorm)
    return vcor, err_begin, err_end


def _test_grad(param0, fun_grad, dx=1e-5):
    f0, g_ana = fun_grad(param0)
    g_num = np.zeros_like(g_ana)
    for i in range(len(param0)):
        p1 = param0.copy()
        p1[i] += dx
        p2 = param0.copy()
        p2[i] -= dx
        g_num[i] = (fun_grad(p1)[0] - fun_grad(p2)[0]) / (2 * dx)
    log.info("grad check: max |ana - num| = %.3e",
             np.abs(g_ana - g_num).max())
    return g_ana, g_num


def full_fit_objective(rho, lattice, basis, vcor, beta, filling,
                       imp_fit=False):
    """The finite-T whole-lattice objective of FitVcorFull for a local
    vcor, as a host function p -> (err, grad): lattice Fock + vcor(p), one
    global-mu Fermi density over the (spin x k) batch through
    zlinalg.zrho_fermi, embedding fold, masked residual; the gradient is
    one backward() through the op's Daleckii-Krein backward.  All tensor
    work runs on the basis' device."""
    from libdmet_preview_tpu_torch.ops import mfd
    from libdmet_preview_tpu_torch.utils.misc import add_spin_dim
    dev = basis.device
    spin = basis.shape[0]
    basis_k = lattice.R2k_basis(basis)
    mask, rho_target = _full_fit_target(rho, lattice, basis, imp_fit)
    Fock_k = lattice.getFock(kspace=True)
    f_re, f_im = np.asarray(Fock_k[0]), np.asarray(Fock_k[1])
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    f_re = as_f64(add_spin_dim(f_re, spin, non_spin_dim=3), dev)
    f_im = as_f64(add_spin_dim(f_im, spin, non_spin_dim=3), dev)
    nk, nlo = f_re.shape[1], f_re.shape[-1]
    # single mu across spin channels and k (mfd.HF's convention for a
    # scalar filling); electron count on the DOUBLED spectrum
    nelec2 = mfd.check_nelec(spin * nk * 2 * nlo * float(filling))[0]
    grad_tab = as_f64(np.asarray(vcor.gradient())[:, :spin], dev)
    fi_flat = f_im.reshape(spin * nk, nlo, nlo)

    def err_full(p):
        F_re = f_re + torch.einsum("P, Psij -> sij", p, grad_tab)[:, None]
        r_re, r_im, _ = _zl.zrho_fermi(
            F_re.reshape(spin * nk, nlo, nlo), fi_flat, nelec2, float(beta))
        remb = embham.transform_h1(
            (r_re.reshape(spin, nk, nlo, nlo),
             r_im.reshape(spin, nk, nlo, nlo)), basis_k)
        return torch.linalg.norm(remb * mask - rho_target) \
            / np.sqrt(1.0 * spin)

    fg_dev = _value_and_grad(err_full)

    def fun_grad(p):
        FitVcorFull.n_eval += 1
        e, g = fg_dev(as_f64(p, dev))
        return to_host(e, float), to_host(g)

    return fun_grad


def _full_fit_target(rho, lattice, basis, imp_fit):
    """(mask, masked target) of the whole-lattice fit on the basis'
    device; imp_fit restricts the residual to the impurity block."""
    spin, neo = basis.shape[0], basis.shape[-1]
    rho_target = as_f64(rho, basis.device)
    mask = torch.ones((spin, neo, neo), dtype=torch.float64,
                      device=basis.device)
    if imp_fit:
        mask[:] = 0.0
        mask[:, :lattice.nimp, :lattice.nimp] = 1.0
        rho_target = rho_target * mask
    return mask, rho_target


def FitVcorFull(rho, lattice, basis, vcor, beta, filling, MaxIter=20,
                imp_fit=False, **kwargs):
    """Whole-lattice fit stage: re-solve the lattice mean field at each
    step and match the folded rdm1, on the basis' device.  imp_fit
    restricts the residual to the impurity block.

    At finite beta with a local vcor the objective is full_fit_objective,
    minimized by minimize_cg and checked by scipy's CG / BFGS as in
    FitVcorEmb; otherwise (zero T, non-local vcor) by Powell's
    derivative-free method over the one-shot mean field.
    FitVcorFull.n_eval counts the objective evaluations since the caller
    last set it to 0.  Returns (vcor, err_begin, err_end)."""
    from libdmet_preview_tpu_torch.ops import mfd

    dev = basis.device
    spin = basis.shape[0]
    restricted = (spin == 1)

    if beta < np.inf and vcor.islocal():
        fun_grad = full_fit_objective(rho, lattice, basis, vcor, beta,
                                      filling, imp_fit=imp_fit)
        p0 = vcor.param.copy()
        err_begin = fun_grad(p0)[0]
        x, err_end, gnorm = minimize_cg(fun_grad, p0, max_iter=MaxIter,
                                        ytol=kwargs.get("ytol", 1e-8),
                                        gtol=kwargs.get("gtol", 1e-4))
        if kwargs.get("CG_check", False) or kwargs.get("BFGS", False) \
                or gnorm > 1e-3:
            from scipy import optimize as opt
            r = opt.minimize(lambda p: fun_grad(p)[0], x,
                             jac=lambda p: fun_grad(p)[1],
                             method="BFGS" if kwargs.get("BFGS") else "CG",
                             options={"maxiter": MaxIter,
                                      "gtol": max(gnorm * 0.1, 5e-5)})
            if r.fun < err_end:
                x, err_end = r.x, float(r.fun)
        vcor.update(np.asarray(x))
        return vcor, err_begin, float(err_end)

    basis_k = lattice.R2k_basis(basis)
    mask, rho_target = _full_fit_target(rho, lattice, basis, imp_fit)

    # derivative-free path (zero T, or a non-local vcor): Powell over the
    # one-shot mean field
    def cost(p):
        FitVcorFull.n_eval += 1
        vcor.update(p)
        _, _, _, res = mfd.HF(lattice, vcor, filling, restricted, beta=beta,
                              ires=True)
        rho1 = embham.foldRho_k(
            tuple(as_f64(x, dev) for x in res["rho_k"]), basis_k) * mask
        return to_host(torch.linalg.norm(rho1 - rho_target) / np.sqrt(spin),
                       float)

    from scipy import optimize as opt
    p0 = vcor.param.copy()
    err_begin = cost(p0)
    res = opt.minimize(cost, p0, method="Powell",
                       options={"maxiter": MaxIter, "xtol": 1e-7})
    if res.fun <= err_begin:
        vcor.update(res.x)
        return vcor, err_begin, float(res.fun)
    vcor.update(p0)
    return vcor, err_begin, err_begin


FitVcorFull.n_eval = 0


def FitVcorTwoStep(rho, lattice, basis, vcor, beta, filling, MaxIter1=300,
                   MaxIter2=0, **kwargs):
    """Two-step fit wrapper: the embedding-space stage (MaxIter1), then
    the whole-lattice stage (MaxIter2)."""
    vcor_new = copy.deepcopy(vcor)
    err_begin = err_end = None
    if MaxIter1 > 0:
        vcor_new, err_begin, err_end = FitVcorEmb(rho, lattice, basis,
                                                  vcor_new, beta,
                                                  MaxIter=MaxIter1, **kwargs)
    if MaxIter2 > 0:
        vcor_new, err_begin2, err_end = FitVcorFull(rho, lattice, basis,
                                                    vcor_new, beta, filling,
                                                    MaxIter=MaxIter2, **kwargs)
        if err_begin is None:
            err_begin = err_begin2
    log.result("residue (begin) = %s", err_begin)
    log.result("residue (end)   = %s", err_end)
    return vcor_new, err_end


def cvx_frac(mo_coeff, rho_target, nelec, tol=1e-10):
    """Convex fractional-occupation fit in closed form (host NumPy).

    Find occupations 0 <= w <= 1 with sum(w) = nelec minimizing
    || C diag(w) C^T - rho ||_F.  For orthonormal C the objective
    separates and the optimum is the Euclidean projection of
    d = diag(C^T rho C) onto the capped simplex: w = clip(d + lam, 0, 1)
    with lam fixed by the trace, a scalar bisection."""
    C = np.asarray(mo_coeff)
    d = np.diag(C.T @ np.asarray(rho_target) @ C).copy()
    assert 0.0 <= nelec <= d.size + 1e-9

    lo, hi = -1.0 - d.max(), 1.0 - d.min() + 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(np.clip(d + mid, 0.0, 1.0).sum()) < nelec:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return np.clip(d + 0.5 * (lo + hi), 0.0, 1.0)
