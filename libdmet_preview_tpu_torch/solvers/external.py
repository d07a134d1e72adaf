"""
External solver bridge (PyTorch port of
libdmet_preview_tpu/solvers/external.py): FCIDUMP out, subprocess run,
energy / RDM back.

The bridge takes the executable configuration explicitly and degrades to
"unavailable" (raises at run), so the library imports everywhere.  Output
parsing is line-pattern based.  The files it writes are the JAX package's,
byte for byte; the Hamiltonian may hold arrays or tensors (read to the
host), and the rdm1 it returns is a tensor on `device`.
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


class ExternalFCIDUMPSolver(object):
    """Generic FCIDUMP + subprocess impurity solver.

    Config:
      executable : argv list; '{fcidump}', '{workdir}', '{nelec}' are
                   substituted
      energy_pattern : regex with one float group, LAST match wins
      rdm1_file : optional path (relative to workdir) of a text/npy rdm1
      mpirun / nproc : optional MPI launcher prefix
      device : where the returned rdm1 lives
    """

    def __init__(self, executable, energy_pattern=r"E\s*=\s*([-\d.eE+]+)",
                 rdm1_file=None, mpirun=None, nproc=1, workdir=None,
                 restricted=True, Sz=0, device=torch.device("cuda"),
                 **kwargs):
        self.executable = list(executable)
        self.energy_pattern = energy_pattern
        self.rdm1_file = rdm1_file
        self.mpirun = mpirun
        self.nproc = nproc
        self.workdir = workdir
        self.restricted = restricted
        self.Sz = Sz
        self.device = torch.device(device)
        self.onepdm = None
        self.e_tot = None

    def available(self):
        exe = self.executable[0]
        return os.path.exists(exe) or any(
            os.path.exists(os.path.join(d, exe))
            for d in os.environ.get("PATH", "").split(os.pathsep) if d)

    def run(self, Ham, nelec=None, **kwargs):
        if nelec is None:
            raise ValueError("run requires nelec")
        if not self.available():
            raise RuntimeError("external solver executable not found: %s"
                               % self.executable[0])
        workdir = self.workdir or tempfile.mkdtemp(prefix="ext_solver_")
        os.makedirs(workdir, exist_ok=True)
        fcidump = os.path.join(workdir, "FCIDUMP")
        dump_FCIDUMP(fcidump, Ham, nelec=nelec, spin_sz=self.Sz)

        argv = [a.format(fcidump=fcidump, workdir=workdir, nelec=nelec)
                for a in self.executable]
        if self.mpirun:
            argv = [self.mpirun, "-np", str(self.nproc)] + argv
        log.info("external solver: %s", " ".join(argv))
        res = subprocess.run(argv, cwd=workdir, capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError("external solver failed (rc=%d):\n%s"
                               % (res.returncode, res.stderr[-2000:]))
        matches = re.findall(self.energy_pattern, res.stdout)
        if not matches:
            raise RuntimeError("energy pattern %r not found in solver "
                               "output" % self.energy_pattern)
        E = float(matches[-1])
        self.e_tot = E
        if self.rdm1_file is not None:
            path = os.path.join(workdir, self.rdm1_file)
            if path.endswith(".npy"):
                rdm1 = np.load(path)
            else:
                rdm1 = np.loadtxt(path)
            if rdm1.ndim == 2:
                rdm1 = rdm1[None] * (0.5 if self.restricted else 1.0)
            self.onepdm = as_f64(rdm1, self.device)
        return self.onepdm, E

    def cleanup(self):
        pass


def Block2Solver(executable="block2main", **kwargs):
    """DMRG via block2 (if installed)."""
    return ExternalFCIDUMPSolver(
        [executable, "{fcidump}"],
        energy_pattern=r"DMRG energy\s*=\s*([-\d.eE+]+)", **kwargs)


def SHCISolver(executable="Dice", **kwargs):
    """SHCI via Dice (if installed)."""
    return ExternalFCIDUMPSolver(
        [executable, "{workdir}/input.dat"],
        energy_pattern=r"PTEnergy:\s*([-\d.eE+]+)", **kwargs)


def AFQMCSolver(executable="afqmc", **kwargs):
    """AFQMC via an external binary: FCIDUMP in, mean energy parsed from
    the measurement output."""
    return ExternalFCIDUMPSolver(
        [executable, "{fcidump}"],
        energy_pattern=r"[Ee]nergy[:=\s]+([-\d.eE+]+)", **kwargs)


def DQMCSolver(executable="DQMC", mpirun="mpirun", nproc=1, **kwargs):
    """DQMC via Sandeep Sharma's code: mpirun-launched, blocking-analysis
    mean energy."""
    return ExternalFCIDUMPSolver(
        [executable, "{workdir}/dqmc.json"],
        energy_pattern=r"[Ee]nergy[:=\s]+([-\d.eE+]+)\s*\+/-",
        mpirun=mpirun, nproc=nproc, **kwargs)


# ----------------------------------------------------------------------
# solver-specific Hamiltonian dumps: the sparse AFQMC text format and the
# Cholesky HDF5 of DQMC
# ----------------------------------------------------------------------

def dump_afqmc_ham(filename, Ham, eta=1e-12):
    """Sparse text dump of an (unrestricted Hubbard-type) embedding
    Hamiltonian for an external AFQMC code: per-spin nonzero hoppings +
    per-site Hubbard U diagonal.  Returns the on-site U vector."""
    H1 = to_host(Ham.H1["cd"])
    if H1.shape[0] == 1:
        H1 = np.concatenate([H1, H1])
    n = Ham.norb
    H2 = to_host(Ham.H2["ccdd"])
    g_ab = H2[2] if H2.shape[0] == 3 else H2[0]
    U = np.array([g_ab[i, i, i, i] for i in range(n)])
    with open(filename, "w") as f:
        f.write("norb %d\n" % n)
        for s in range(2):
            nz = [(i, j, H1[s, i, j]) for i in range(n) for j in range(n)
                  if abs(H1[s, i, j]) > eta]
            f.write("h1 spin %d nnz %d\n" % (s, len(nz)))
            for i, j, v in nz:
                f.write("%5d %5d %s\n" % (i, j, repr(float(v))))
        f.write("hubbard_u %d\n" % n)
        for i in range(n):
            f.write("%5d %s\n" % (i, repr(float(U[i]))))
        f.write("h0 %s\n" % repr(float(Ham.H0)))
    return U


def read_afqmc_ham(filename):
    """Read back a dump_afqmc_ham file: (H1 (2, n, n), U (n,), H0)."""
    with open(filename) as f:
        tok = f.readline().split()
        n = int(tok[1])
        H1 = np.zeros((2, n, n))
        for s in range(2):
            nnz = int(f.readline().split()[-1])
            for _ in range(nnz):
                i, j, v = f.readline().split()
                H1[s, int(i), int(j)] = float(v)
        nu = int(f.readline().split()[-1])
        U = np.zeros(nu)
        for _ in range(nu):
            i, v = f.readline().split()
            U[int(i)] = float(v)
        H0 = float(f.readline().split()[-1])
    return H1, U, H0


def dump_dqmc_cholesky(filename, Ham, tol=1e-9):
    """HDF5 dump of the embedding Hamiltonian with Cholesky-decomposed
    two-body integrals (the DQMC contract): hcore per spin, factors L with
    eri ~= sum_x L_x (x) L_x, core energy, sizes.  Returns the rank."""
    import h5py
    from libdmet_preview_tpu_torch.ops.eri_transform import cholesky_eri
    from libdmet_preview_tpu_torch.models.integral import restore_eri
    n = Ham.norb
    H1 = to_host(Ham.H1["cd"])
    if H1.shape[0] == 1:
        H1 = np.concatenate([H1, H1])
    g = restore_eri(to_host(Ham.H2["ccdd"][0]), n, 1)
    L = cholesky_eri(g, tol=tol)
    with h5py.File(filename, "w") as f:
        f["hcore_a"] = H1[0]
        f["hcore_b"] = H1[1]
        f["chol"] = L.reshape(L.shape[0], -1)
        f["e0"] = np.asarray(float(Ham.H0))
        f["norb"] = np.asarray(n)
        f["nchol"] = np.asarray(L.shape[0])
    return L.shape[0]


def read_dqmc_cholesky(filename):
    import h5py
    with h5py.File(filename, "r") as f:
        n = int(f["norb"][()])
        L = f["chol"][()].reshape(-1, n, n)
        return (np.asarray([f["hcore_a"][()], f["hcore_b"][()]]), L,
                float(f["e0"][()]))
