"""
Embedding vcor-fit engines (PyTorch port of libdmet_preview_tpu/ops/fit.py:
_cg_engine, _lm_engine_ft, _lm_loop).

The JAX package runs each engine as one lax.while_loop program.  PyTorch
runs eagerly, so here each engine is a Python loop over tensor math on the
caller's device: the tensor work stays on the device, and every
accept/reject or stop decision reads its operands to the host once (one
host read per decision).  Every constant and every stopping rule of the
JAX engines is kept, so both packages take the same path and land on the
same parameters.
"""

import torch

from libdmet_preview_tpu_torch.ops import zlinalg as _zl


def _cg_engine(fg, x0, max_iter, ytol, gtol, dx_tol=1e-7):
    """Polak-Ribiere CG with backtracking-Armijo search.
    fg: x -> (f, grad) tensors.  Returns (x, f, max|g|) tensors."""
    f, g = fg(x0)
    x = x0
    d = -g
    step0 = 1.0
    n_small = 0
    done = float(torch.max(torch.abs(g))) < gtol * 0.1
    it = 0
    while not done and it < max_iter:
        dg0 = torch.dot(g, d)
        d = torch.where(dg0 >= 0, -g, d)
        dg = torch.where(dg0 >= 0, -torch.dot(g, g), dg0)

        # Armijo 1e-4, alpha * 0.4 per rejection, at most 30 trials
        alpha = step0
        f_new, g_new = f, g
        found = False
        for _ in range(30):
            f_try, g_try = fg(x + alpha * d)
            if bool(f_try <= f + 1e-4 * alpha * dg):
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
        df, dx_h, gmax = torch.stack(
            [f - f_new, dx, torch.max(torch.abs(g_new))]).tolist()
        n_small = n_small + 1 if df < ytol else 0
        done = (not found) or n_small >= 2 or dx_h < dx_tol \
            or gmax < gtol * 0.1
        if found:
            x = x + alpha * d
            f, g, d = f_new, g_new, d_new
        it += 1
    return x, f, torch.max(torch.abs(g))


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
    err_h, gmax_h = torch.stack(
        [err, torch.max(torch.abs(grad(err, J, r)))]).tolist()
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
        err_t_h, gmax_t_h = torch.stack(
            [err_t, torch.max(torch.abs(grad(err_t, J_t, r_t)))]).tolist()
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
