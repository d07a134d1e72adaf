"""
Robust quadratic extrapolation for the chemical-potential fit
(port of libdmet_preview_tpu/dmet/quad_fit.py, a host copy).
"""

import math
import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log


def _parabola(x, y, tol=1e-12):
    x1, x2, x3 = x
    y1, y2, y3 = y
    denom = float((x1 - x2) * (x1 - x3) * (x2 - x3))
    if abs(denom) < tol:
        return None
    a = (x3 * (y2 - y1) + x2 * (y1 - y3) + x1 * (y3 - y2)) / denom
    b = (x3 * x3 * (y1 - y2) + x2 * x2 * (y3 - y1) + x1 * x1 * (y2 - y3)) / denom
    c = (x2 * x3 * (x2 - x3) * y1 + x3 * x1 * (x3 - x1) * y2
         + x1 * x2 * (x1 - x2) * y3) / denom
    return a, b, c


def quad_fit(mu, dnelecs, tol=1e-12):
    """Fit dnelec(mu) with a parabola and return its root nearest the data.

    Returns (mu_new, success)."""
    mu = np.asarray(mu, dtype=float)
    dn = np.asarray(dnelecs, dtype=float)
    order = np.argsort(mu, kind="mergesort")
    mu, dn = mu[order], dn[order]

    coeffs = _parabola(mu, dn, tol=tol)
    if coeffs is None:
        return 0.0, False
    a, b, c = coeffs
    if abs(a) < tol and abs(b) < tol:
        return 0.0, False
    if abs(a) < tol:
        return -c / b, True
    D = b * b - 4.0 * a * c
    if D < 0:
        return 0.0, False
    r1 = (-b + math.sqrt(D)) / (2.0 * a)
    r2 = (-b - math.sqrt(D)) / (2.0 * a)

    # bracket where the sign change must live
    if dn[0] >= 0.0:
        left, right = -np.inf, mu[0]
    elif dn[1] >= 0.0:
        left, right = mu[0], mu[1]
    elif dn[2] >= 0.0:
        left, right = mu[1], mu[2]
    else:
        left, right = mu[2], np.inf

    in1 = left < r1 < right
    in2 = left < r2 < right
    if in1 and in2:
        return (r1 if abs(r1 - mu[0]) < abs(r2 - mu[0]) else r2), True
    if in1:
        return r1, True
    if in2:
        return r2, True
    return 0.0, False


def _linfit_mu(dnelec, mus):
    """Linear regression mu(dnelec); the intercept is the mu at dnelec=0."""
    A = np.vstack([dnelec, np.ones_like(dnelec)]).T
    coef, *_ = np.linalg.lstsq(A, mus, rcond=None)
    return coef[1]


def quad_fit_mu(mus, nelecs, filling, step):
    """Predict the next dmu from (mu, nelec) history
    (three-point parabola, linear fallback, step clamps)."""
    mus = np.asarray(mus, dtype=float)
    nelecs = np.asarray(nelecs, dtype=float)
    target = filling * 2.0
    dnelec = nelecs - target

    idx = np.argsort(np.abs(dnelec), kind="mergesort")
    mus_sub = mus[idx][:3]
    dn_sub = dnelec[idx][:3]

    dmu, ok = quad_fit(mus_sub, dn_sub)
    if ok and np.any(np.abs(mus - dmu) < 1e-7):
        ok = False
    if not ok:
        dmu = _linfit_mu(dn_sub, mus_sub)

    def violates(d):
        return np.any((d - mus) * (target - nelecs) < 0.0)

    if violates(dmu):
        dmu = _linfit_mu(dn_sub, mus_sub)
        if violates(dmu):
            dmu = math.copysign(max(step, 1e-3), target - nelecs[-1]) + mus[-1]

    if abs(dmu - mus[-1]) > step:
        dmu = math.copysign(step, dmu - mus[-1]) + mus[-1]
    if np.any(np.abs(mus - dmu) < 1e-7):
        dmu = math.copysign(step, dmu - mus[-1]) + mus[-1]
    if (dmu - mus[-1]) * (target - nelecs[-1]) < 0 and abs(dmu - mus[-1]) > 2e-3:
        dmu = math.copysign(step, target - nelecs[-1]) + mus[-1]
    log.result("extrapolated to dMu = %20.12f", dmu)
    return dmu
