"""
The three-band configurations with the coupled-cluster solver: the
program's side (the lattice through the program's factories, one DMET job
through its run_dmet with solvers.CCSD, its counters and spans) and the
reference of reference/three_band_cc.py that judges a job.  The interface
is three_band_emery's.
"""

import contextlib

import numpy as np
import torch

from perfbench.models import three_band_emery
from perfbench.reference import loop
from perfbench.reference.three_band_cc import DMET

# the program's counters (utils.timer.count) that counters() reports
COUNTERS = ("cc amplitude steps", "cc adjoint matvecs", "scf roothaan steps",
            "scf rotation steps")


class Program(three_band_emery.Program):
    """The system under test for one configuration: the lattice with its
    Hamiltonian on `device`, built as three_band_emery builds it (its
    sigma_builds stays 0: no FCI runs here)."""

    inst = None

    def job(self, start, filling, max_iter):
        """One DMET job from the vcor parameters `start`: UHF-DMET with a
        non-interacting bath and CCSD(restricted=False) through run_dmet.
        {"history": [per iteration E, nelec, last_dmu, vcor_param,
        rho_imp, fit_err], "vcor": the final parameters, "mu": the last
        mean-field mu}."""
        import libdmet_preview_tpu_torch.dmet.hubbard as dmet
        from libdmet_preview_tpu_torch.dmet.loop import run_dmet
        from libdmet_preview_tpu_torch.solvers import CCSD
        from libdmet_preview_tpu_torch.utils.config import DmetConfig
        d = self.cfg["dmet"]
        vcor = dmet.VcorLocal(False, False, self.nsc)
        vcor.update(np.asarray(start, dtype=float))
        solver = CCSD(restricted=False, tol=d["solver_tol"],
                      device=self.device)
        conf = DmetConfig(
            filling=filling, restricted=False, int_bath=False,
            use_hcore_as_emb_ham=d["use_hcore_as_emb_ham"],
            max_iter=max_iter, conv_tol_E=d["conv_tol_E"],
            conv_tol_vcor=d["conv_tol_vcor"], diis_start=d["diis_start"],
            diis_dim=d["diis_dim"], trace_start=d["trace_start"],
            mu_thrnelec=d["mu_thrnelec"], mu_step=d["mu_step"],
            fit_max_iter=d["fit_max_iter"], solver=d["solver"],
            solver_tol=d["solver_tol"])
        res = run_dmet(self.lattice, vcor, conf, solver=solver)
        keys = ("E", "nelec", "last_dmu", "vcor_param", "rho_imp",
                "fit_err")
        return {"history": [{k: r[k] for k in keys} for r in res.history],
                "vcor": np.array(res.vcor.param, copy=True),
                "mu": float(res.mu)}

    def reset_counters(self):
        from libdmet_preview_tpu_torch.ops import fit
        fit._cg_engine.steps = 0
        self.inst = None

    def counters(self):
        """The program's counters since reset_counters(): the vcor fit's
        CG steps (ops.fit._cg_engine.steps) and, where the window was
        recorded (instrument()), the totals of COUNTERS over the
        recording; the program counts those only while a recording is
        open."""
        from libdmet_preview_tpu_torch.ops import fit
        out = {"cg_steps": fit._cg_engine.steps}
        if self.inst is not None:
            out.update({k: self.inst.spans.total(k) for k in COUNTERS})
        return out

    def instrument(self, device):
        self.inst = _Instrument()
        return self.inst


class _Instrument(object):
    """The traced window's program readings: the program's spans
    (utils.timer stages, {name: seconds}); its counters stay on the
    recording, which timer.last() returns once the window has closed."""

    def __enter__(self):
        from libdmet_preview_tpu_torch.utils import timer
        self._stack = contextlib.ExitStack()
        self.spans = self._stack.enter_context(timer.recording())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def read(self):
        return {"spans": {k: sum(v) for k, v in self.spans.items()}}


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
