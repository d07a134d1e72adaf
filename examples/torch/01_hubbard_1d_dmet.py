#!/usr/bin/env python
"""
1D Hubbard DMET, the canonical workflow, on the PyTorch port (reference
analog: examples/dmet/01-dmet-1D-Hubbard).  Converges to E/site ~= -0.5527
(NIB) for U/t = 4 at half filling with a 2-site impurity.

Run: python examples/torch/01_hubbard_1d_dmet.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.ops.diis import DIIS  # noqa: E402
from libdmet_preview_tpu_torch.solvers import FCI  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

U, LatSize, ImpSize, Filling = 4.0, 18, 2, 0.5
Mu, last_dmu = U * Filling, 0.0

Lat = dmet.ChainLattice(LatSize, ImpSize)
Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
vcor = dmet.PMInitGuess(ImpSize, U, Filling)
solver = FCI(restricted=True, tol=1e-11, device=device)
mu_solver = dmet.MuSolver(adaptive=True)
adiis = DIIS(space=4)

E_old = 0.0
for it in range(20):
    rho, Mu, res = dmet.RHartreeFock(Lat, vcor, Filling, Mu, ires=True)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                              matching=False, int_bath=False)
    ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(Lat, Filling, ImpHam, basis,
                                               solver, solver_args)
    last_dmu += dmu
    rhoImp, E, nelec = dmet.transformResults(
        rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
        last_dmu=last_dmu, int_bath=False, solver=solver,
        solver_args=solver_args)
    vcor_new, err = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf, Filling,
                                 MaxIter2=0)
    pvcor = adiis.update(np.hstack(vcor_new.param)) if it >= 4 \
        else np.hstack(vcor_new.param)
    dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
    vcor.update(pvcor)
    print("iter %2d  E/site = %.10f  dE = %.2e  dVcor = %.2e"
          % (it, E, E - E_old, dV))
    if dV < 1e-5 and abs(E - E_old) < 1e-5 and it > 3:
        print("converged.")
        break
    E_old = E
