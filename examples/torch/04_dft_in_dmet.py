#!/usr/bin/env python
"""
DFT-in-DMET on the PyTorch port: an LSDA Kohn-Sham lattice mean field with
the xc double counting, FCI in the embedding (reference analog: the
KRKSpU/pdft_helper DFT+DMET workflow).  The KS potential is the autograd
gradient of the functional on a native quadrature grid -- no libxc, no
PySCF.

Run: python examples/torch/04_dft_in_dmet.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.models.abinitio import (  # noqa: E402
    attach_ks, make_h_ring_lattice)
from libdmet_preview_tpu_torch.solvers import FCI  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

# H6 ring, 2 atoms per cell; KS-LSDA lattice state
Lat, meta = make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                basis="sto-6g", device=device)
ks = attach_ks(Lat, meta, xc="lsda")
print("KS (LSDA) total energy     : %.8f" % ks.e_tot)
print("HF total energy            : %.8f" % meta["E_hf"])

nlo = meta["nlo"]
vcor = dmet.VcorLocal(True, False, nlo)
vcor.update(np.zeros(vcor.length()))
filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
solver = FCI(restricted=True, tol=1e-12, device=device)
mu_solver = dmet.MuSolver(adaptive=True)
solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
rho, mu = dmet.RHartreeFock(Lat, vcor, filling, None)
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=True)
last_dmu = 0.0
for it in range(15):
    rhoEmb, E_emb, ImpHam, dmu = mu_solver(Lat, filling, ImpHam, basis,
                                           solver, solver_args)
    last_dmu += dmu
    rhoImp, EnergyImp, nelecImp = dmet.transformResults(
        rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
        last_dmu=last_dmu, int_bath=True, solver=solver,
        solver_args=solver_args)
    if abs(nelecImp - 2 * filling) < 1e-6:
        break
E_cell = EnergyImp * nlo - float(ImpHam.H0) \
    + meta["mole"].energy_nuc() / 3.0
print("DMET(FCI @ KS-LSDA) E/cell : %.8f  (nelec/imp %.6f)"
      % (E_cell, nelecImp * nlo))
