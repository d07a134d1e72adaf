#!/usr/bin/env python
"""
One-shot DMET on the 3-band Emery (cuprate) model with literature
parameters, on the PyTorch port (reference analog: the Hubbard3band
workflows).  UHF mean field, CuO2-cell Schmidt bath, FCI impurity with a
chemical-potential fit; prints the charge-transfer hole distribution.

Run: python examples/torch/05_threeband_cuprate.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.models.hamiltonian import \
    Hubbard3band_ref  # noqa: E402
from libdmet_preview_tpu_torch.models.lattice import Square3Band  # noqa: E402
from libdmet_preview_tpu_torch.solvers import FCI  # noqa: E402
from libdmet_preview_tpu_torch.utils.misc import to_host  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

Lat = Square3Band(2, 2, 1, 1)
Ham = Hubbard3band_ref(Lat, name="Hanke")
Lat.set_Ham(Ham, use_hcore_as_emb_ham=True, device=device)
nlo = Lat.nscsites
vcor = dmet.VcorLocal(False, False, nlo)
vcor.update(np.zeros(vcor.length()))
filling = 5.0 / 6.0            # one hole per CuO2

rho, Mu = dmet.HartreeFock(Lat, vcor, filling, None)
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=False)
solver = FCI(restricted=False, tol=1e-11, device=device)
mu_solver = dmet.MuSolver(adaptive=True)
solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
last_dmu = 0.0
for it in range(25):
    rhoEmb, E_emb, ImpHam, dmu = mu_solver(Lat, filling, ImpHam, basis,
                                           solver, solver_args, step=0.3)
    last_dmu += dmu
    rhoImp, EnergyImp, nelecImp = dmet.transformResults(
        rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
        last_dmu=last_dmu, int_bath=False, solver=solver,
        solver_args=solver_args)
    if abs(nelecImp - 2 * filling) < 5e-7:
        break
occ = np.sum(to_host(rhoImp), axis=0).diagonal()
hole = 2.0 - occ
print("nelec per CuO2       : %.6f  (target %.6f)"
      % (nelecImp * nlo, 2 * filling * nlo))
print("DMET energy per site : %.8f" % EnergyImp)
print("hole distribution    : d %.4f  px %.4f  py %.4f"
      % (hole[0], hole[1], hole[2]))
