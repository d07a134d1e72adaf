"""
The three-band (Emery) configurations: the program's side (the lattice
through the program's factories, one DMET job through its run_dmet, its
counters and spans) and the reference that judges a job.

An adapter module gives: Program(cfg, device) with .nparam, .job(start,
filling, max_iter), .reset_counters(), .counters() -> {name: count} and
.instrument(device) (a context whose read() gives the traced window's
program readings); judge(cfg, mix, answer, device, sample) -> {number:
reading}; control(cfg, mix, start, device) -> an answer.
"""

import contextlib

import numpy as np
import torch

from perfbench.reference import loop
from perfbench.reference.model import DMET


class Program(object):
    """The system under test for one configuration: the lattice with its
    Hamiltonian on `device`, and the sigma builds summed over its jobs."""

    def __init__(self, cfg, device):
        import libdmet_preview_tpu_torch.dmet.hubbard as dmet
        self.cfg, self.device = cfg, torch.device(device)
        lc = cfg["lattice"]
        self.lattice = getattr(dmet, lc["factory"])(*lc["size"],
                                                    *lc["supercell"])
        ham = dmet.Hubbard3band_ref(
            self.lattice, name=dict(cfg["parameters"]),
            hole_rep=cfg["representation"] == "hole",
            ignore_intercell=cfg["ignore_intercell"])
        self.lattice.set_Ham(
            ham, use_hcore_as_emb_ham=cfg["dmet"]["use_hcore_as_emb_ham"],
            device=self.device)
        self.nsc = self.lattice.nscsites
        self.nparam = dmet.VcorLocal(False, False, self.nsc).length()
        self.sigma_builds = 0

    def job(self, start, filling, max_iter):
        """One DMET job from the vcor parameters `start`: UHF-DMET with a
        non-interacting bath and FCI(restricted=False) through run_dmet.
        {"history": [per iteration E, nelec, last_dmu, vcor_param,
        rho_imp, fit_err], "vcor": the final parameters, "mu": the last
        mean-field mu}."""
        import libdmet_preview_tpu_torch.dmet.hubbard as dmet
        from libdmet_preview_tpu_torch.dmet.loop import run_dmet
        from libdmet_preview_tpu_torch.solvers import FCI
        from libdmet_preview_tpu_torch.utils.config import DmetConfig
        d = self.cfg["dmet"]
        vcor = dmet.VcorLocal(False, False, self.nsc)
        vcor.update(np.asarray(start, dtype=float))
        solver = FCI(restricted=False, tol=d["solver_tol"],
                     device=self.device)
        conf = DmetConfig(
            filling=filling, restricted=False, int_bath=False,
            use_hcore_as_emb_ham=d["use_hcore_as_emb_ham"],
            max_iter=max_iter, conv_tol_E=d["conv_tol_E"],
            conv_tol_vcor=d["conv_tol_vcor"], diis_start=d["diis_start"],
            diis_dim=d["diis_dim"], trace_start=d["trace_start"],
            mu_thrnelec=d["mu_thrnelec"], mu_step=d["mu_step"],
            fit_max_iter=d["fit_max_iter"], solver="FCI",
            solver_tol=d["solver_tol"])
        res = run_dmet(self.lattice, vcor, conf, solver=solver)
        self.sigma_builds += solver.n_sigma
        keys = ("E", "nelec", "last_dmu", "vcor_param", "rho_imp",
                "fit_err")
        return {"history": [{k: r[k] for k in keys} for r in res.history],
                "vcor": np.array(res.vcor.param, copy=True),
                "mu": float(res.mu)}

    def reset_counters(self):
        from libdmet_preview_tpu_torch.ops import fit
        self.sigma_builds = 0
        fit._cg_engine.steps = 0

    def counters(self):
        """The program's counters since reset_counters(): the FCI sigma
        builds (FCI.n_sigma) and the vcor fit's CG steps
        (ops.fit._cg_engine.steps)."""
        from libdmet_preview_tpu_torch.ops import fit
        return {"sigma_builds": self.sigma_builds,
                "cg_steps": fit._cg_engine.steps}

    def instrument(self, device):
        return _Instrument(device)


class _Instrument(object):
    """The traced window's program readings: the program's spans
    (utils.timer stages, {name: seconds}) and, on a card, every sigma
    application that solvers.fci.make_sigma returns timed by CUDA events
    ({(norb, nelec_a, nelec_b): (calls, seconds)})."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events = {}

    def __enter__(self):
        from libdmet_preview_tpu_torch.solvers import fci
        from libdmet_preview_tpu_torch.utils import timer
        self._stack = contextlib.ExitStack()
        self.spans = self._stack.enter_context(timer.recording())
        if self.cuda:
            orig = fci.make_sigma
            fci.make_sigma = self._timed(orig)
            self._stack.callback(setattr, fci, "make_sigma", orig)
        return self

    def _timed(self, make_sigma):
        def wrapped(h1e, eri, norb, nelec, device):
            sigma, hdiag = make_sigma(h1e, eri, norb, nelec, device)
            marks = self.events.setdefault((norb,) + tuple(nelec), [])

            def timed(c):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = sigma(c)
                e1.record()
                marks.append((e0, e1))
                return out
            return timed, hdiag
        return wrapped

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def read(self):
        if self.cuda:
            torch.cuda.synchronize()
        sigma = {k: (len(v), sum(a.elapsed_time(b) for a, b in v) * 1e-3)
                 for k, v in self.events.items()}
        return {"spans": {k: sum(v) for k, v in self.spans.items()},
                "sigma": sigma}


def judge(cfg, mix, answer, device, sample=None, fits=None):
    """The reference's readings of loop.NUMBERS for a job (fits: see
    loop.follow)."""
    dm = DMET(cfg, device, torch.float64)
    return loop.follow(dm, cfg["dmet"], mix["filling"], answer["start"],
                       answer, sample, fits)


def control(cfg, mix, start, device, dtype=torch.float32):
    """The reference loop at a lower precision, in the program's place."""
    dm = DMET(cfg, device, dtype)
    return dict(loop.job(dm, cfg["dmet"], mix["filling"], start,
                         mix["max_iter"]), start=start)
