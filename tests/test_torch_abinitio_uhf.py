"""
The slice as a whole: one-shot interacting-bath UHF-DMET on an ab initio
lattice, the driver of tests/test_cuo2_afm.py:52-76, run on the AFM H ring
(tests/test_torch_mfd.py) by the JAX package and by the PyTorch port on
the CPU:

    HartreeFock -> ConstructImpHam(int_bath=True, matching=True)
    -> SCFSolver(restricted=False).run(ImpHam, nelec, dm0=folded rdm1)
    -> transformResults(int_bath=True)
"""

import os
import subprocess
import sys

import numpy as np
import torch

from test_torch_embham import both_imp_ham

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_shot_ib_uhf_dmet_matches_jax():
    import libdmet_preview_tpu.dmet.hubbard as jdmet
    from libdmet_preview_tpu.ops import embham as jembham
    from libdmet_preview_tpu.solvers import SCFSolver
    import libdmet_preview_tpu_torch.dmet.hubbard as tdmet
    from libdmet_preview_tpu_torch.solvers import SCFSolver as TSCFSolver
    (Lat, _, _, ImpHam, H1e, basis), \
        (lat_t, _, _, ImpHam_t, H1e_t, basis_t) = both_imp_ham()

    rho_mf = np.asarray(jembham.foldRho_k(Lat.rdm1_lo_k,
                                          Lat.R2k_basis(basis)))
    nel = int(round(np.trace(rho_mf[0]) + np.trace(rho_mf[1])))
    hf = SCFSolver(restricted=False)
    rdm1, E = hf.run(ImpHam, nelec=nel, dm0=rho_mf)
    _, E_cell, n_cell = jdmet.transformResults(
        rdm1, E, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
        int_bath=True, solver=hf, solver_args={"nelec": nel})

    rho_mf_t = tdmet.foldRho_k(lat_t.rdm1_lo_k, lat_t.R2k_basis(basis_t))
    nel_t = int(round(float(torch.trace(rho_mf_t[0])
                            + torch.trace(rho_mf_t[1]))))
    assert nel_t == nel
    hf_t = TSCFSolver(restricted=False, device=torch.device("cpu"))
    rdm1_t, E_t = hf_t.run(ImpHam_t, nelec=nel, dm0=rho_mf_t)
    _, E_cell_t, n_cell_t = tdmet.transformResults(
        rdm1_t, E_t, basis_t, ImpHam_t, H1e_t, lattice=lat_t, last_dmu=0.0,
        int_bath=True, solver=hf_t, solver_args={"nelec": nel})

    assert np.isfinite(E_cell_t)
    assert abs(E_cell_t - E_cell) < 1e-8
    assert abs(n_cell_t - n_cell) < 1e-10


def test_port_import_needs_no_jax_or_h5py():
    """Importing the whole port loads neither jax, the JAX package nor
    h5py (the machine with the card has none of them)."""
    code = ("import sys, libdmet_preview_tpu_torch; "
            "import libdmet_preview_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m in ('jax', 'h5py', "
            "'libdmet_preview_tpu') or m.startswith(('jax.', 'h5py.', "
            "'libdmet_preview_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
