#!/usr/bin/env python
"""
Ab initio DMET on DIAMOND with GTH pseudopotentials, on the PyTorch port,
entirely through its native integral engine: GTH-SZV sp valence basis +
GTH-PADE pseudopotentials, Ewald-split periodic Coulomb, range-separated
ERIs; no PySCF anywhere.

Builds the fcc 2-atom primitive cell on a BvK torus of 2 cells, runs
supercell RHF, Lowdin-localizes, and performs one interacting-bath DMET
iteration with a CCSD impurity solver.  The HF-solver identity (DMET(HF)
== lattice HF) validates the full embedding chain at ~1e-8.

Run: python examples/torch/06_diamond_dmet.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.models.abinitio import \
    make_diamond_lattice  # noqa: E402
from libdmet_preview_tpu_torch.ops import embham  # noqa: E402
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal  # noqa: E402
from libdmet_preview_tpu_torch.solvers import CCSD, SCFSolver  # noqa: E402
from libdmet_preview_tpu_torch.utils.misc import to_host  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

t0 = time.time()
Lat, meta = make_diamond_lattice(nk=2, device=device)
nsc = Lat.nscsites
print("diamond (C2, GTH-SZV/GTH-PADE) x %d cells: nao=%d  built in %.0fs"
      % (Lat.ncells, meta["cell"].nao, time.time() - t0))
print("supercell RHF:  E/cell = %.8f" % (meta["E_hf"] / Lat.ncells))

vcor = VcorLocal(True, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
print("lattice mean field: E/cell = %.8f  gap = %.3f"
      % (res["E"], float(np.min(res["gap"]))))
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = to_host(embham.foldRho_k(Lat.rdm1_lo_k, basis_k))
nel = int(round(np.trace(rho_mf[0])))
nel += nel % 2

hf = SCFSolver(restricted=True, device=device)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel)
_, E_hf, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                   lattice=Lat, last_dmu=0.0,
                                   int_bath=True, solver=hf,
                                   solver_args={"nelec": nel})
print("DMET(HF)/cell   = %.8f   (identity check: %.2e)"
      % (E_hf * nsc, E_hf * nsc - meta["E_hf"] / Lat.ncells))

cc = CCSD(restricted=True, tol=1e-8, device=device)
rhoEmb, EEmb = cc.run(ImpHam, nelec=nel)
_, E_cc, n_cc = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                      lattice=Lat, last_dmu=0.0,
                                      int_bath=True, solver=cc,
                                      solver_args={"nelec": nel})
print("DMET(CCSD)/cell = %.8f   E_corr/cell = %.6f  nelec = %.4f"
      % (E_cc * nsc, E_cc * nsc - meta["E_hf"] / Lat.ncells, n_cc * nsc))
print("total %.0fs" % (time.time() - t0))
