"""
DMRG (Block / StackBlock / Block2 family) impurity-solver bridge (PyTorch
port of libdmet_preview_tpu/solvers/dmrg.py).

The external C++ DMRG binaries are driven through their text
configuration language, FCIDUMP integrals and pdm files: sweep-schedule
generation, dmrg.conf writing, subprocess launch (optionally under
mpirun), sweep-energy parsing and 1/2-pdm readback in both the text and
the binary (interleaved spin-orbital) formats -- so a real Block2 run needs
only the executable path.  The files written are the JAX package's, byte
for byte; the pdms read back are tensors on the solver's `device`.  The
bridge is testable without the binary through a fake executable that
reads the conf + FCIDUMP, solves the problem, and emits Block-format
outputs (tests/test_dmrg_bridge.py).
"""

import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64, to_host
from libdmet_preview_tpu_torch.models.integral import dump_FCIDUMP


# ----------------------------------------------------------------------
# sweep schedule (the Block configuration-language `schedule` block)
# ----------------------------------------------------------------------

class Schedule(object):
    """Sweep schedule: bond dimensions, Davidson tolerances and noise per
    sweep window, rendered into the Block `schedule ... end` section."""

    DEFAULT_M = (250, 400, 800, 1500, 2500, 3500, 5000)

    def __init__(self, max_iter=35, sweep_tol=1e-6, sweeps_per_M=5):
        self.max_iter = int(max_iter)
        self.sweep_tol = float(sweep_tol)
        self.sweeps_per_M = int(sweeps_per_M)
        self.arrayM = None
        self.arraySweep = None
        self.arrayTol = None
        self.arrayNoise = None
        self.twodot_to_onedot = None

    @property
    def initialized(self):
        return self.arrayM is not None

    def gen_initial(self, min_M, max_M, sweeps_per_M=None):
        """Cold-start ramp: geometric bond-dimension ladder min_M ->
        max_M with loosening-then-tightening Davidson tolerances and a
        final noise-free window, then switch to one-dot sweeps."""
        k = self.sweeps_per_M if sweeps_per_M is None else sweeps_per_M
        Ms = [int(min_M)] + [M for M in self.DEFAULT_M
                             if min_M < M < max_M] + [int(max_M)]
        tols = [min(1e-4, self.sweep_tol * 0.1 * 10.0 ** i)
                for i in range(len(Ms))][::-1]
        tols = [max(t, 1e-6) for t in tols]
        noise = [max(t * 10.0, 1e-5) for t in tols]
        # converged window: same M, tightest tol, zero noise
        Ms.append(int(max_M))
        tols.append(tols[-1])
        noise.append(0.0)
        self.arrayM = Ms
        self.arraySweep = [k * i for i in range(len(Ms))]
        self.arrayTol = tols
        self.arrayNoise = noise
        self.twodot_to_onedot = self.arraySweep[-1] + k
        self.max_iter = max(self.max_iter, self.twodot_to_onedot + k)
        return self

    def gen_restart(self, M):
        """Warm restart at fixed M (DMET iterations after the first)."""
        self.arrayM = [int(M)] * 3
        self.arraySweep = [0, 1, 3]
        self.arrayTol = [self.sweep_tol, self.sweep_tol * 0.1,
                         self.sweep_tol * 0.1]
        self.arrayNoise = [self.sweep_tol, self.sweep_tol * 0.1, 0.0]
        self.twodot_to_onedot = 6
        self.max_iter = max(self.max_iter, 9)
        return self

    def gen_extrapolate(self, M):
        """Single fixed-M window for truncation-error extrapolation."""
        self.arrayM = [int(M)]
        self.arraySweep = [0]
        self.arrayTol = [self.sweep_tol * 0.1]
        self.arrayNoise = [0.0]
        self.twodot_to_onedot = 0
        self.max_iter = 2
        return self

    def gen_custom(self, arrayM, arraySweep, arrayTol, arrayNoise,
                   twodot_to_onedot=None):
        self.arrayM = list(arrayM)
        self.arraySweep = list(arraySweep)
        self.arrayTol = list(arrayTol)
        self.arrayNoise = list(arrayNoise)
        if twodot_to_onedot is None:
            twodot_to_onedot = self.arraySweep[-1] + 2
        self.twodot_to_onedot = twodot_to_onedot
        self.max_iter = max(self.max_iter, self.arraySweep[-1] + 2)
        return self

    def get_schedule(self):
        assert self.initialized, "schedule not generated"
        lines = ["", "schedule"]
        for s, M, t, nz in zip(self.arraySweep, self.arrayM,
                               self.arrayTol, self.arrayNoise):
            lines.append("%d %d %.0e %.0e" % (s, M, t, nz))
        lines.append("end")
        lines.append("")
        lines.append("maxiter %d" % self.max_iter)
        if self.twodot_to_onedot <= 0:
            lines.append("onedot")
        elif self.twodot_to_onedot >= self.max_iter:
            lines.append("twodot")
        else:
            lines.append("twodot_to_onedot %d" % self.twodot_to_onedot)
        lines.append("sweep_tol %.0e" % self.sweep_tol)
        lines.append("")
        return "\n".join(lines)


# ----------------------------------------------------------------------
# pdm readback (Block text + binary output formats)
# ----------------------------------------------------------------------

def read1pdm(filename):
    """Text 1-pdm: first line nsites, then 'i j value' rows."""
    with open(filename) as f:
        lines = f.readlines()
    n = int(lines[0])
    pdm = np.zeros((n, n))
    for line in lines[1:]:
        tok = line.split()
        if len(tok) == 3:
            pdm[int(tok[0]), int(tok[1])] = float(tok[2])
    return pdm


def read2pdm(filename):
    """Text 2-pdm <i+ j+ k l> -> chemist/pyscf order
    rdm2[i, l, j, k] (the index permutation Block's output needs)."""
    with open(filename) as f:
        lines = f.readlines()
    n = int(lines[0])
    pdm = np.zeros((n, n, n, n))
    for line in lines[1:]:
        tok = line.split()
        if len(tok) == 5:
            pdm[int(tok[0]), int(tok[3]),
                int(tok[1]), int(tok[2])] = float(tok[4])
    return pdm


def read1pdm_bin(filename, norb, raw_data=False):
    """Binary spin-orbital 1-pdm: trailing (2 norb)^2 float64 block,
    alpha/beta interleaved; returns (2, norb, norb) spatial channels."""
    size = (2 * norb) ** 2 * 8
    with open(filename, "rb") as f:
        raw = f.read()[-size:]
    t = np.frombuffer(raw, dtype=np.float64).reshape(2 * norb, 2 * norb)
    if raw_data:
        return t
    return np.stack([t[::2, ::2], t[1::2, 1::2]])


def read2pdm_bin(filename, norb, raw_data=False):
    """Binary spin-orbital 2-pdm: trailing (2 norb)^4 float64, permuted
    pqrs -> psqr into pyscf order; returns (3, ...) aa/bb/ab channels."""
    size = (2 * norb) ** 4 * 8
    with open(filename, "rb") as f:
        raw = f.read()[-size:]
    t = np.frombuffer(raw, dtype=np.float64).reshape((2 * norb,) * 4)
    t = t.transpose(0, 3, 1, 2)
    if raw_data:
        return t
    return np.stack([t[::2, ::2, ::2, ::2], t[1::2, 1::2, 1::2, 1::2],
                     t[::2, ::2, 1::2, 1::2]])


# ----------------------------------------------------------------------
# the bridge solver
# ----------------------------------------------------------------------

class BlockDMRG(object):
    """Block/Block2-style DMRG impurity solver over dmrg.conf + FCIDUMP.

    executable : argv list for the DMRG binary (e.g. ['block2main'] or
                 ['/path/to/block.spin_adapted']); '{conf}' entries are
                 substituted with the configuration path, otherwise the
                 conf path is appended.
    schedule   : a Schedule (default: gen_initial(250, max_M))
    device     : where the pdms read back live
    Contract: run(Ham, nelec) -> (rdm1 (spin, n, n) tensor, E);
              run_dmet_ham(Ham_scaled) -> energy from the stored 2-pdm.
    """

    energy_patterns = (
        r"Sweep Energy\s*=\s*([-\d.eE+]+)",
        r"DMRG Energy\s*=\s*([-\d.eE+]+)",
        r"E\s*=\s*([-\d.eE+]+)",
    )

    def __init__(self, executable, max_M=800, schedule=None, mpirun=None,
                 nproc=1, workdir=None, restricted=True, Sz=0,
                 spin_adapted=True, reorder=False, warmup="local_2site",
                 hf_occ="integral", outputlevel=1, twopdm=True,
                 restart=True, device=torch.device("cuda"), **kwargs):
        self.executable = list(executable)
        self.max_M = int(max_M)
        self.schedule = schedule
        self.mpirun = mpirun
        self.nproc = nproc
        self.workdir = workdir
        self.restricted = restricted
        self.Sz = Sz
        self.spin_adapted = spin_adapted
        self.reorder = reorder
        self.warmup = warmup
        self.hf_occ = hf_occ
        self.outputlevel = outputlevel
        self.twopdm = twopdm
        self.restart = restart
        self.device = torch.device(device)
        self.optimized = False     # becomes True after a converged run
        self.onepdm = None
        self.twopdm_val = None
        self.e_tot = None
        self._last_ham = None

    def available(self):
        exe = self.executable[0]
        return os.path.exists(exe) or any(
            os.path.exists(os.path.join(d, exe))
            for d in os.environ.get("PATH", "").split(os.pathsep) if d)

    # ------------------------------------------------------------------
    def write_conf(self, path, fcidump, nelec, norb, onepdm=True,
                   twopdm=None, prefix=None, fullrestart=False):
        if twopdm is None:
            twopdm = self.twopdm
        sched = self.schedule
        if sched is None or not sched.initialized:
            sched = Schedule()
            if self.optimized and self.restart:
                sched.gen_restart(self.max_M)
            else:
                sched.gen_initial(min(250, self.max_M), self.max_M)
        lines = []
        lines.append("nelec %d" % nelec)
        lines.append("spin %d" % self.Sz)
        if isinstance(self.hf_occ, str):
            lines.append("hf_occ %s" % self.hf_occ)
        else:
            lines.append("hf_occ " + " ".join(str(o) for o in self.hf_occ))
        lines.append(sched.get_schedule())
        lines.append("orbitals %s" % fcidump)
        lines.append("warmup %s" % self.warmup)
        lines.append("nroots 1")
        lines.append("outputlevel %d" % self.outputlevel)
        lines.append("prefix %s" % (prefix or os.path.dirname(path)))
        if fullrestart or (self.optimized and self.restart):
            lines.append("fullrestart")
        if not self.spin_adapted:
            lines.append("nonspinadapted")
        if not self.reorder:
            lines.append("noreorder")
        if onepdm:
            lines.append("onepdm")
        if twopdm:
            lines.append("twopdm")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    def _parse_energy(self, text):
        for pat in self.energy_patterns:
            hits = re.findall(pat, text)
            if hits:
                return float(hits[-1])
        raise RuntimeError("no DMRG energy found in output")

    def _read_pdms(self, wd, norb):
        rdm1 = rdm2 = None
        cands1 = ["node0/spatial_onepdm.0.0.txt", "spatial_onepdm.0.0.txt",
                  "onepdm.0.0.txt", "node0/onepdm.0.0.bin",
                  "onepdm.0.0.bin", "1pdm.npy"]
        for c in cands1:
            p = os.path.join(wd, c)
            if os.path.exists(p):
                if c.endswith(".bin"):
                    rdm1 = read1pdm_bin(p, norb)
                elif c.endswith(".npy"):
                    rdm1 = np.load(p)
                else:
                    m = read1pdm(p)
                    rdm1 = np.stack([m, m]) * 0.5 if m.shape[0] == norb \
                        else m
                break
        cands2 = ["node0/spatial_twopdm.0.0.txt", "spatial_twopdm.0.0.txt",
                  "node0/twopdm.0.0.bin", "twopdm.0.0.bin", "2pdm.npy"]
        for c in cands2:
            p = os.path.join(wd, c)
            if os.path.exists(p):
                if c.endswith(".bin"):
                    rdm2 = read2pdm_bin(p, norb)
                elif c.endswith(".npy"):
                    rdm2 = np.load(p)
                else:
                    rdm2 = read2pdm(p)
                break
        return rdm1, rdm2

    # ------------------------------------------------------------------
    def run(self, Ham, nelec=None, **kwargs):
        if nelec is None:
            raise ValueError("run requires nelec")
        if not self.available():
            raise RuntimeError("DMRG executable not found: %s"
                               % self.executable[0])
        wd = self.workdir or tempfile.mkdtemp(prefix="dmrg_")
        os.makedirs(wd, exist_ok=True)
        norb = Ham.norb
        fcidump = os.path.join(wd, "FCIDUMP")
        dump_FCIDUMP(fcidump, Ham, nelec=nelec, spin_sz=self.Sz)
        conf = os.path.join(wd, "dmrg.conf")
        self.write_conf(conf, fcidump, nelec, norb, prefix=wd)
        argv = []
        if self.mpirun:
            argv += [self.mpirun, "-n", str(self.nproc)]
        subbed = False
        for a in self.executable:
            if "{conf}" in a:
                argv.append(a.replace("{conf}", conf))
                subbed = True
            else:
                argv.append(a)
        if not subbed:
            argv.append(conf)
        log.info("DMRG bridge: %s", " ".join(argv))
        proc = subprocess.run(argv, cwd=wd, capture_output=True, text=True)
        out = proc.stdout + proc.stderr
        with open(os.path.join(wd, "dmrg.out"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError("DMRG failed (rc=%d); see %s/dmrg.out"
                               % (proc.returncode, wd))
        e = self._parse_energy(out)
        rdm1, rdm2 = self._read_pdms(wd, norb)
        if rdm1 is None:
            raise RuntimeError("DMRG produced no 1-pdm in %s" % wd)
        self.onepdm = as_f64(np.asarray(rdm1), self.device)
        self.twopdm_val = None if rdm2 is None else as_f64(rdm2, self.device)
        self.e_tot = e
        self.optimized = True
        self._last_ham = Ham
        if self.restricted and self.onepdm.shape[0] == 2:
            rdm1_out = self.onepdm.sum(dim=0)[None] * 0.5
        else:
            rdm1_out = self.onepdm
        return rdm1_out, e

    def make_rdm2(self, *args, **kwargs):
        return self.twopdm_val

    def run_dmet_ham(self, Ham, **kwargs):
        """Energy of the scaled DMET Hamiltonian: contract the stored
        1/2-pdms (host NumPy)."""
        if self.onepdm is None:
            raise RuntimeError("run() must precede run_dmet_ham()")
        H1 = to_host(Ham.H1["cd"])
        H2 = to_host(Ham.H2["ccdd"])
        spin = H1.shape[0]
        rdm1 = to_host(self.onepdm)
        if spin == 1 and rdm1.shape[0] == 2:
            rdm1_tot = rdm1.sum(axis=0)
        elif spin == 1:
            rdm1_tot = rdm1[0] * 2.0
        e1 = np.einsum("pq, qp ->", H1[0], rdm1_tot) if spin == 1 else \
            sum(np.einsum("pq, qp ->", H1[s], rdm1[s]) for s in range(2))
        rdm2 = self.twopdm_val
        if rdm2 is None:
            raise RuntimeError("no 2-pdm stored; run with twopdm=True")
        rdm2 = to_host(rdm2)
        if rdm2.ndim == 5:   # (aa, bb, ab)
            e2 = 0.5 * (np.einsum("pqrs, pqrs ->", H2[0], rdm2[0])
                        + np.einsum("pqrs, pqrs ->",
                                    H2[min(1, H2.shape[0] - 1)], rdm2[1])) \
                + np.einsum("pqrs, pqrs ->",
                            H2[min(2, H2.shape[0] - 1)], rdm2[2])
        else:
            e2 = 0.5 * np.einsum("pqrs, pqrs ->", H2[0], rdm2)
        return float(e1 + e2 + Ham.H0)

    def cleanup(self):
        pass
