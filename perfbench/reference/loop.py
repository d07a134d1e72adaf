"""
The reference's two drivers over the steps of reference/model.py.

follow() judges a DMET job of the program.  It walks the job's iterations
from the start the benchmark handed it: for each iteration it works out
the mean field of the vcor the program held, the bath, the embedding
Hamiltonian, the FCI at the dmu the program reports, the energy and the
density; then it takes the program's fitted vcor through its own trace
fix and DIIS to the next iteration's vcor.  It cannot redo the dmu search
step by step (the program's secant and quadratic steps depend on its own
electron counts), nor follow the fit's CG: it holds what each settled on.
The dmu: the reference's electron count at it against the filling's
target.  The fit: its reported error against the reference's error of
the fitted vcor, and that error against the reference's own minimum from
the same input vcor.  Returns the worst reading of each compared number.

job() is the reference DMET loop itself, a program of its own at a chosen
dtype: at float32 it is the control that the comparison has to refuse.
"""

import numpy as np

from perfbench.reference.model import (DMET, Fit, Pulay, trace_fix,
                                       vcor_matrix, vcor_param)

NUMBERS = ("e_site", "rdm_imp", "nelec", "nelec_target", "fit_err",
           "fit_short", "vcor", "mu")


def fit_shortfall(err_prog, err_in, err_min):
    """The share of the decrease the fit could make from its inputs that
    the program's fit left undone, pooled over the judged iterations
    (arrays, or one iteration's scalars): the sum of the program's one-sided
    excess over the reference's minimum (a program that ends below it adds
    0) over the sum of the input's excess.  0 at the minima, 1 for a fit
    that returns its input.  Pooled, since the late iterations' possible
    decrease falls to the CG's own stopping scale."""
    short = np.maximum(0.0, np.subtract(err_prog, err_min)).sum()
    return float(short / max(np.subtract(err_in, err_min).sum(), 1e-12))


def follow(dm, dmet_cfg, filling, start, job, sample=None, fits=None):
    """Readings of NUMBERS for job = {"history": [...], "vcor": params,
    "mu": float} against the reference dm (a model.DMET at float64).
    sample: the iterations whose impurity problem and fit are redone
    (all when None); the mean field and the vcor chain run for every
    iteration.  fits: a list that receives, per redone iteration, the
    fit's error and gradient norm at its input, at the program's vcor
    and at the reference's minimum."""
    n = dm.nsc
    hist = job["history"]
    v = vcor_matrix(np.asarray(start, dtype=float), n)
    diis = Pulay(dmet_cfg["diis_dim"])
    mu = None
    worst = dict.fromkeys(NUMBERS, 0.0)
    errs = []

    def note(key, x):
        x = float(x)
        worst[key] = x if not np.isfinite(x) else max(worst[key], x)

    for i, rec in enumerate(hist):
        rho, mu = dm.mean_field(v, filling, mu)
        v_prog = vcor_matrix(np.asarray(rec["vcor_param"], float), n)
        if sample is None or i in sample:
            B = dm.bath(rho)
            h1 = dm.emb_h1(B, v)
            g = dm.emb_eri(B.shape[-1])
            dmu = float(rec["last_dmu"])
            E, rdm = dm.solve(h1, g, dmu)
            e, ne, rimp = dm.energy(h1, rdm, E, dmu)
            note("e_site", abs(e - rec["E"]))
            note("nelec", abs(ne - rec["nelec"]))
            if i >= 1:
                # the search starts from the last dmu; in iteration 0 it
                # starts from 0 and its steps cannot reach the filling
                note("nelec_target", abs(ne / (2.0 * filling) - 1.0))
            note("rdm_imp", np.max(np.abs(rimp.cpu().numpy()
                                          - np.asarray(rec["rho_imp"]))))
            fit = Fit(dm, B, rdm)
            err_at = fit.err(vcor_param(v_prog))
            note("fit_err", abs(rec["fit_err"] - err_at))
            x_in = vcor_param(v)
            x_min, err_min = fit.minimize(x_in)
            err_in = fit.err(x_in)
            errs.append((err_at, err_in, err_min))
            if fits is not None:
                fits.append({"iteration": i, "err_in": err_in,
                             "err_prog": err_at, "err_min": err_min, **{
                                 "g_" + k: float(np.linalg.norm(
                                     fit.err_grad(x)[1]))
                                 for k, x in (("in", x_in),
                                              ("prog", vcor_param(v_prog)),
                                              ("min", x_min))}})
        if i >= dmet_cfg["trace_start"]:
            note("vcor", abs(np.mean([np.diag(v_prog[s] - v[s])
                                      for s in range(2)])))
        p = vcor_param(v_prog)
        v = vcor_matrix(diis(p) if i >= dmet_cfg["diis_start"] else p, n)
    if errs:
        note("fit_short", fit_shortfall(*np.transpose(errs)))
    note("vcor", np.max(np.abs(np.asarray(job["vcor"], float)
                               - vcor_param(v))))
    note("mu", abs(job["mu"] - mu))
    return worst


def _dmu_search(dm, h1, g, target, dmu, step, thr, max_solves=6):
    """The impurity filling by secant steps from dmu, each at most step:
    (dmu, E, rdm) of the last solve."""
    n = dm.nsc

    def count(x):
        E, rdm = dm.solve(h1, g, x)
        return E, rdm, float(sum(rdm[s, :n, :n].trace() for s in range(2)))

    x0 = dmu
    E, rdm, n0 = count(x0)
    x1 = x0 + float(np.clip(target - n0, -step, step))
    for _ in range(max_solves - 1):
        if abs(n0 / target - 1.0) < thr:
            break
        E, rdm, n1 = count(x1)
        slope = (n1 - n0) / (x1 - x0) if abs(x1 - x0) > 1e-12 else 1.0
        if abs(slope) < 1e-6:
            slope = 1.0
        x0, n0 = x1, n1
        x1 = x1 + float(np.clip((target - n1) / slope, -step, step))
    return x0, E, rdm


def job(dm, dmet_cfg, filling, start, max_iter):
    """One reference DMET job at dm's dtype: {"history", "vcor", "mu"} in
    the layout of the program's job."""
    n = dm.nsc
    dt = dm.np_dtype
    v = vcor_matrix(np.asarray(start, dtype=dt), n)
    diis = Pulay(dmet_cfg["diis_dim"], dt)
    mu, last_dmu, hist = None, 0.0, []
    for it in range(max_iter):
        rho, mu = dm.mean_field(v, filling, mu)
        B = dm.bath(rho)
        h1 = dm.emb_h1(B, v)
        g = dm.emb_eri(B.shape[-1])
        last_dmu, E, rdm = _dmu_search(
            dm, h1, g, 2.0 * n * filling, last_dmu, dmet_cfg["mu_step"],
            dmet_cfg["mu_thrnelec"])
        e, ne, rimp = dm.energy(h1, rdm, E, last_dmu)
        fit = Fit(dm, B, rdm)
        x, err = fit.minimize(vcor_param(v).astype(float))
        v_new = vcor_matrix(np.asarray(x, dtype=dt), n)
        if it >= dmet_cfg["trace_start"]:
            v_new = trace_fix(v_new, v)
        p = vcor_param(v_new)
        hist.append({"E": e, "nelec": ne, "last_dmu": last_dmu,
                     "vcor_param": p.copy(), "fit_err": err,
                     "rho_imp": rimp.cpu().numpy()})
        v = vcor_matrix(diis(p) if it >= dmet_cfg["diis_start"] else p, n)
    return {"history": hist, "vcor": vcor_param(v), "mu": mu}
