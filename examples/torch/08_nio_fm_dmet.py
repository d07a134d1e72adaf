#!/usr/bin/env python
"""
Ferromagnetic NiO ab initio DMET on the PyTorch port (the reference's
examples/dmet/04-dmet-nio-fm/nio_fm.py, which fixes cell.spin = 4 per
double cell through PySCF KUHF + GDF).  The same native stack and
rhombohedral double cell as the AFM flagship (07), with both Ni aligned:
fixed-Sz supercell UHF (n_alpha - n_beta = 4 per cell), spin-resolved
lattice filling, and interacting-bath UHF-DMET on the net-spin embedding.
Shares the integral cache with example 07 (same cell); only the UHF state
differs.

Run: python examples/torch/08_nio_fm_dmet.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.models.abinitio import \
    make_nio_fm_lattice  # noqa: E402
from libdmet_preview_tpu_torch.ops import embham  # noqa: E402
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal  # noqa: E402
from libdmet_preview_tpu_torch.solvers import SCFSolver  # noqa: E402
from libdmet_preview_tpu_torch.utils.misc import to_host  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

cache = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                     "build", "example_cache")
os.makedirs(cache, exist_ok=True)
Lat, meta = make_nio_fm_lattice(nk=2, cache_file=cache, device=device)
nsc = Lat.nscsites
na, nb = meta["nelec_ab"]
print("supercell UHF  E/cell = %.8f   (n_a - n_b = %d)"
      % (meta["E_hf"] / 2, na - nb))
print("aligned Ni d moments (Lowdin): %+0.4f / %+0.4f"
      % tuple(meta["mag_ni"]))

# lattice mean field at spin-resolved filling
filling = (na / (Lat.ncells * nsc), nb / (Lat.ncells * nsc))
vcor = VcorLocal(False, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
print("lattice MF == supercell UHF: |dE| = %.2e"
      % abs(res["E"] - meta["E_hf"] / 2))

# interacting-bath UHF-DMET on the net-spin embedding
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = embham.foldRho_k(Lat.rdm1_lo_k, basis_k)
tr = [float(np.trace(to_host(rho_mf[s]))) for s in range(2)]
nel = int(round(tr[0] + tr[1]))
sz = int(round(tr[0] - tr[1]))
hf = SCFSolver(restricted=False, Sz=sz, device=device)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
_, E_dmet, _ = dmet.transformResults(
    rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=hf, solver_args={"nelec": nel})
print("IB UHF-DMET E/cell = %.8f  (identity |dE| = %.2e)"
      % (E_dmet * nsc, abs(E_dmet * nsc - meta["E_hf"] / 2)))
