#!/usr/bin/env python
"""
Superconducting DMET on the attractive Hubbard model, on the PyTorch port
(GSO frame: number-conserving treatment of pairing; reference analog:
HubbardBCS/HubbardGSO workflows).  Develops an s-wave order parameter.

Run: python examples/torch/02_sc_dmet_attractive_hubbard.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from libdmet_preview_tpu_torch.dmet import hubbard_bcs as dmet  # noqa: E402
from libdmet_preview_tpu_torch.ops import spinless  # noqa: E402
from libdmet_preview_tpu_torch.ops.diis import DIIS  # noqa: E402
from libdmet_preview_tpu_torch.solvers import FCI  # noqa: E402
from libdmet_preview_tpu_torch.utils.analysis import \
    get_order_param_sc  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

L, nimp, U, filling = 12, 2, -4.0, 0.5
Lat = dmet.ChainLattice(L, nimp)
Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True, device=device)
gham = dmet.GSOHam(Lat)
nao = Lat.nscsites
vcor = dmet.VcorSC(nao)
p0 = np.zeros(vcor.length())
nV = vcor.length() - nao * (nao + 1) // 2
for k, (i, j) in enumerate([(0, 0), (0, 1), (1, 1)]):
    if i == j:
        p0[nV + k] = 0.2            # onsite s-wave pairing seed
vcor.update(p0)

solver = FCI(restricted=True, ghf=True, tol=1e-11, device=device)
adiis = DIIS(space=4)
E_old, mu = 0.0, -2.0
for it in range(20):
    vmat = spinless.combine_vcor(np.asarray(vcor.get()))
    GRho, mu, res = dmet.GHartreeFock(gham, filling, mu0=mu, vcor_mat=vmat)
    ImpHam, _, basis = dmet.ConstructImpHam(gham, GRho, mu, vcor_mat=vmat)
    rdm, E_emb, ImpHam_d, dmu = dmet.SolveImpHam_with_fitting(
        gham, filling, ImpHam, basis, solver, thrnelec=1e-7)
    GRhoImp, Efrag, n = dmet.transformResults(rdm, E_emb, basis, ImpHam_d,
                                              gham, mu, last_dmu=dmu)
    vcor_new, err = dmet.FitVcor(rdm, Lat, basis, vcor, gham, mu,
                                 MaxIter=200)
    pvcor = adiis.update(np.asarray(vcor_new.param)) if it >= 3 \
        else np.asarray(vcor_new.param)
    dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
    vcor.update(pvcor)
    print("iter %2d  E/cell = %.8f  n = %.6f  |kappa| = %.4f  dVcor = %.2e"
          % (it, Efrag, n, get_order_param_sc(GRhoImp), dV))
    if dV < 1e-5 and abs(Efrag - E_old) < 1e-6 and it > 3:
        print("converged with SC order parameter %.4f"
              % get_order_param_sc(GRhoImp))
        break
    E_old = Efrag
