"""
External-solver interfaces with result readback: SHCI, AFQMC, DQMC
(PyTorch port of libdmet_preview_tpu/solvers/qmc.py).

File formats: JSON config + CSV / text tables (the JAX package's files,
byte for byte).  The statistical machinery -- weighted means over
measurement series, reblocking error analysis with plateau detection,
per-rank weight-averaged RDMs, the mixed-estimator extrapolation
2*D - D_mf -- is host NumPy; the RDMs a run returns are tensors on the
solver's `device` (tests/test_qmc_bridge.py drives fake binaries).
"""

import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64, to_host
from libdmet_preview_tpu_torch.models.integral import dump_FCIDUMP
from libdmet_preview_tpu_torch.solvers.external import (dump_afqmc_ham,
                                                       dump_dqmc_cholesky)


# ----------------------------------------------------------------------
# statistics: reblocking error analysis
# ----------------------------------------------------------------------

def blocking_analysis(samples, weights=None, neql=0, min_blocks=16):
    """Reblocking analysis of a (weighted) correlated measurement
    series: successively pair-average the series; the error estimate of
    the weighted mean grows until the block length exceeds the
    autocorrelation time and plateaus.  Returns
    (mean, err, table) with table rows (block_len, nblocks, err);
    err is the plateau value (max over block sizes with >= min_blocks
    blocks -- the standard conservative choice)."""
    x = np.asarray(samples, dtype=float)[neql:]
    w = (np.ones_like(x) if weights is None
         else np.asarray(weights, dtype=float)[neql:])
    if x.size == 0:
        raise ValueError("no samples after equilibration cut")
    mean = float(np.sum(w * x) / np.sum(w))
    table = []
    xb, wb = x, w
    blk = 1
    best = 0.0
    while xb.size >= min_blocks:
        nb = xb.size
        mb = np.sum(wb * xb) / np.sum(wb)
        # weighted variance of block means -> error of the mean
        weff = wb / np.sum(wb)
        var = np.sum(weff * (xb - mb) ** 2) / max(1.0, (nb - 1))
        err = float(np.sqrt(var * np.sum(weff ** 2) * nb))
        table.append((blk, nb, err))
        best = max(best, err)
        n2 = (xb.size // 2) * 2
        wp = wb[:n2:2] + wb[1:n2:2]
        xp = (wb[:n2:2] * xb[:n2:2] + wb[1:n2:2] * xb[1:n2:2]) / wp
        xb, wb = xp, wp
        blk *= 2
    return mean, best, table


def read_weighted_matrix(path):
    """Per-rank RDM file: first line = weight, then the matrix rows (the
    rdm_up_%d.dat layout)."""
    with open(path) as f:
        weight = float(f.readline())
    return weight, np.loadtxt(path, skiprows=1)


def average_rank_rdms(paths, hermi=True):
    """Weight-averaged RDM over per-rank files, hermitized."""
    acc, wtot = 0.0, 0.0
    for p in paths:
        w, m = read_weighted_matrix(p)
        acc = acc + w * m
        wtot += w
    rdm = acc / wtot
    if hermi:
        rdm = 0.5 * (rdm + rdm.T)
    return rdm


def read_meas_series(path):
    """Measurement series file: columns (index, value[, weight]);
    '#' comments allowed.  Returns (values, weights)."""
    data = np.atleast_2d(np.loadtxt(path, comments="#"))
    vals = data[:, 1]
    wts = data[:, 2] if data.shape[1] > 2 else np.ones_like(vals)
    return vals, wts


def read_matrix_with_errors(path, shape):
    """Matrix-element series dump: lines 're im err' per element in C
    order.  Returns (matrix, err)."""
    raw = np.atleast_2d(np.loadtxt(path, comments="#"))
    vals = raw[:, 0] + 1j * raw[:, 1]
    errs = raw[:, 2]
    m = vals.reshape(shape)
    if np.abs(m.imag).max() < 1e-8:
        m = m.real
    return m, errs.reshape(shape)


class _SubprocessSolver(object):
    """Shared mechanics: workdir, launcher, availability."""

    def __init__(self, executable, mpirun=None, nproc=1, workdir=None,
                 restricted=False, Sz=0, device=torch.device("cuda")):
        self.executable = executable
        self.device = torch.device(device)
        self.mpirun = mpirun
        self.nproc = nproc
        self.workdir = workdir
        self.restricted = restricted
        self.Sz = Sz
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.e_err = None
        self.count = 0

    def available(self):
        exe = self.executable
        return os.path.exists(exe) or any(
            os.path.exists(os.path.join(d, exe))
            for d in os.environ.get("PATH", "").split(os.pathsep) if d)

    def _workdir(self):
        if self.workdir is None:
            self.workdir = tempfile.mkdtemp(prefix=type(self).__name__)
        os.makedirs(self.workdir, exist_ok=True)
        return self.workdir

    def _launch(self, argv, cwd):
        if self.mpirun:
            argv = [self.mpirun, "-np", str(self.nproc)] + argv
        log.info("%s: %s", type(self).__name__, " ".join(argv))
        out = os.path.join(cwd, "%s.out.%03d" % (type(self).__name__,
                                                 self.count))
        with open(out, "w") as f:
            rc = subprocess.run(argv, cwd=cwd, stdout=f,
                                stderr=subprocess.STDOUT).returncode
        if rc != 0:
            with open(out) as f:
                tail = f.read()[-2000:]
            raise RuntimeError("%s failed (rc=%d):\n%s"
                               % (type(self).__name__, rc, tail))
        self.count += 1
        return out

    def cleanup(self):
        pass


class SHCI(_SubprocessSolver):
    """Semistochastic heat-bath CI via an Arrow/Dice-style binary:
    FCIDUMP + JSON config in, energy from result.json, spatial 1-RDM from
    1rdm.csv ('i,j,val' triplets), optional 2-RDM from 2rdm.csv,
    variational-wavefunction restart."""

    def __init__(self, executable="shci", eps_vars=(2e-4, 1e-4, 5e-5),
                 eps_vars_schedule=(2e-3, 1e-3, 5e-4), var_only=True,
                 **kwargs):
        super().__init__(executable, **kwargs)
        self.eps_vars = list(eps_vars)
        self.eps_vars_schedule = list(eps_vars_schedule)
        self.var_only = var_only
        self.optimized = False

    def run(self, Ham, nelec=None, calc_rdm2=False, restart=False,
            **kwargs):
        if nelec is None:
            raise ValueError("SHCI.run requires nelec")
        if not self.available():
            raise RuntimeError("SHCI executable not found: %s"
                               % self.executable)
        wd = self._workdir()
        n_up = (nelec + self.Sz) // 2
        n_dn = (nelec - self.Sz) // 2
        dump_FCIDUMP(os.path.join(wd, "FCIDUMP"), Ham, nelec=nelec,
                     spin_sz=self.Sz)
        conf = {"system": "chem", "n_up": n_up, "n_dn": n_dn,
                "eps_vars": self.eps_vars,
                "eps_vars_schedule": self.eps_vars_schedule,
                "var_only": self.var_only, "get_1rdm_csv": True,
                "get_2rdm_csv": bool(calc_rdm2),
                "load_integrals_cache": bool(restart and self.optimized),
                "chem": {"point_group": "C1"}}
        with open(os.path.join(wd, "config.json"), "w") as f:
            json.dump(conf, f, indent=1)
        self._launch([self.executable], wd)

        with open(os.path.join(wd, "result.json")) as f:
            res = json.load(f)
        E = float(res.get("energy_total", res.get("energy_var")))
        self.e_tot = E
        n = Ham.norb
        rdm1 = np.zeros((n, n))
        raw = np.loadtxt(os.path.join(wd, "1rdm.csv"), delimiter=",",
                         skiprows=1)
        for i, j, v in np.atleast_2d(raw):
            rdm1[int(i), int(j)] = v
            rdm1[int(j), int(i)] = v
        # spatial (spin-traced) 1-RDM -> per-spin restricted convention
        self.onepdm = as_f64((rdm1 * 0.5)[None] if self.restricted else
                             np.asarray([rdm1 * 0.5, rdm1 * 0.5]),
                             self.device)
        if calc_rdm2:
            self.make_rdm2(Ham)
        self.optimized = True
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """Spin-summed spatial 2-RDM from 2rdm.csv
        ('p,q,r,s,val' in chemist (pq|rs) order)."""
        wd = self._workdir()
        n = self.onepdm.shape[-1]
        G = np.zeros((n, n, n, n))
        raw = np.loadtxt(os.path.join(wd, "2rdm.csv"), delimiter=",",
                         skiprows=1)
        for p, q, r, s, v in np.atleast_2d(raw):
            G[int(p), int(q), int(r), int(s)] = v
        self.twopdm = as_f64(G[None], self.device)
        return self.twopdm


class AFQMC(_SubprocessSolver):
    """Auxiliary-field QMC bridge: sparse Hamiltonian dump + options
    file, measurement-series readback with equilibration cut and
    reblocking errors, complex matrix estimators (cicj / sisj) with
    per-element uncertainties."""

    def __init__(self, executable="afqmc", dt=0.01, beta=50.0,
                 therm_frac=0.1, seed=96384297, **kwargs):
        super().__init__(executable, **kwargs)
        self.settings = {"dt": dt, "beta": beta, "seed": seed}
        self.therm_frac = therm_frac

    def run(self, Ham, nelec=None, **kwargs):
        if not self.available():
            raise RuntimeError("AFQMC executable not found: %s"
                               % self.executable)
        wd = self._workdir()
        dump_afqmc_ham(os.path.join(wd, "model_param.dat"), Ham)
        opts = dict(self.settings)
        if nelec is not None:
            opts["nelec"] = int(nelec)
        with open(os.path.join(wd, "method_param.json"), "w") as f:
            json.dump(opts, f, indent=1)
        self._launch([self.executable], wd)

        vals, wts = read_meas_series(os.path.join(wd, "measurements.dat"))
        neql = int(len(vals) * self.therm_frac)
        E, dE, table = blocking_analysis(vals, wts, neql=neql)
        log.result("AFQMC energy = %.10f +/- %.2e (blocking over %d "
                   "levels)", E, dE, len(table))
        self.e_tot, self.e_err = E, dE
        n = Ham.norb
        rho, drho = read_matrix_with_errors(
            os.path.join(wd, "cicj.dat"), (2, n, n))
        log.result("AFQMC rdm1 uncertainty (max) = %.2e",
                   float(np.abs(drho).max()))
        self.onepdm = as_f64(np.asarray(rho.real if np.iscomplexobj(rho)
                                        else rho), self.device)
        return self.onepdm, E

    def spin_corr(self, Ham):
        """<S_i . S_j> estimator readback (host array)."""
        n = Ham.norb
        sc, dsc = read_matrix_with_errors(
            os.path.join(self._workdir(), "sisj.dat"), (n, n))
        log.result("AFQMC spin-corr uncertainty (max) = %.2e",
                   float(np.abs(dsc).max()))
        return sc


class DQMC(_SubprocessSolver):
    """Determinantal / phaseless QMC bridge: Cholesky h5 integral dump +
    JSON input, mpirun launch, reblocking of samples.dat, per-rank
    weight-averaged RDM readback with hermitization and the optional
    mixed-estimator extrapolation 2*D - D_mf."""

    def __init__(self, executable="DQMC", dt=0.005, nsteps=50, ndets=50,
                 therm_frac=0.1, **kwargs):
        kwargs.setdefault("mpirun", None)
        super().__init__(executable, **kwargs)
        self.params = {"dt": dt, "nsteps": nsteps, "ndets": ndets}
        self.therm_frac = therm_frac

    def run(self, Ham, nelec=None, rdm1_mf=None, extrap=False, **kwargs):
        if not self.available():
            raise RuntimeError("DQMC executable not found: %s"
                               % self.executable)
        wd = self._workdir()
        dump_dqmc_cholesky(os.path.join(wd, "FCIDUMP_chol"), Ham)
        conf = {"integrals": "FCIDUMP_chol", "left": "uhf",
                "right": "uhf", **self.params}
        if nelec is not None:
            conf["nelec"] = int(nelec)
        with open(os.path.join(wd, "dqmc.json"), "w") as f:
            json.dump(conf, f, indent=1)
        self._launch([self.executable, "dqmc.json"], wd)

        vals, wts = read_meas_series(os.path.join(wd, "samples.dat"))
        neql = int(len(vals) * self.therm_frac)
        E, dE, table = blocking_analysis(vals, wts, neql=neql)
        log.result("DQMC energy = %.10f +/- %.2e", E, dE)
        self.e_tot, self.e_err = E, dE

        ups = sorted(f for f in os.listdir(wd) if f.startswith("rdm_up_"))
        dns = sorted(f for f in os.listdir(wd) if f.startswith("rdm_dn_"))
        rdm_a = average_rank_rdms([os.path.join(wd, f) for f in ups])
        rdm_b = average_rank_rdms([os.path.join(wd, f) for f in dns])
        rdm1 = np.asarray([rdm_a, rdm_b])
        if extrap:
            if rdm1_mf is None:
                raise ValueError("extrap=True needs rdm1_mf")
            rdm1 = 2.0 * rdm1 - to_host(rdm1_mf)
        self.onepdm = as_f64(rdm1, self.device)
        return self.onepdm, E
