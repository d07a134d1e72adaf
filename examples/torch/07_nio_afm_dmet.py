#!/usr/bin/env python
"""
Antiferromagnetic NiO ab initio DMET -- the d-electron flagship -- on the
PyTorch port.  Native end to end: general-l GTH pseudopotentials (s/p/d
nonlocal projectors, C1-C4 local terms), a generated minimal valence basis
(Ni 3s/4s/3p/3d, O 2s/2p), AFM-II rhombohedral double cell on an nk-cell
BvK torus, spin-polarized supercell UHF with an AFM guess, Lowdin
localization, interacting-bath UHF-DMET with bath matching.  The reference
runs this workload through PySCF KUHF + GDF (its examples/dmet/
03-dmet-nio-afm/nio_afm.py); here every integral comes from the port's
McMurchie-Davidson / Ewald engine.  The integrals are cached under
build/example_cache/ (08 reuses them).

Run: python examples/torch/07_nio_afm_dmet.py [--device cuda|cpu]
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
    make_nio_afm_lattice  # noqa: E402
from libdmet_preview_tpu_torch.ops import embham  # noqa: E402
from libdmet_preview_tpu_torch.ops.vcor import VcorLocal  # noqa: E402
from libdmet_preview_tpu_torch.solvers import MP2, SCFSolver  # noqa: E402
from libdmet_preview_tpu_torch.utils.misc import to_host  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

cache = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                     "build", "example_cache")
os.makedirs(cache, exist_ok=True)
Lat, meta = make_nio_afm_lattice(nk=2, cache_file=cache, device=device)
nsc = Lat.nscsites
cell = meta["cell"]
print("supercell UHF  E/cell = %.8f" % (meta["E_hf"] / 2))
print("staggered Ni d moment (Lowdin): %+0.4f / %+0.4f" %
      tuple(meta["mag_ni"]))

Filling = cell.nelectron / (2 * 2.0 * nsc)
vcor = VcorLocal(False, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.HartreeFock(Lat, vcor, Filling, None, ires=True)
print("lattice MF     E/cell = %.8f  (identity dE = %.1e)"
      % (res["E"], abs(res["E"] - meta["E_hf"] / 2)))
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = embham.foldRho_k(Lat.rdm1_lo_k, basis_k)
nel = int(round(float(np.trace(to_host(rho_mf[0]))
                      + np.trace(to_host(rho_mf[1])))))

hf = SCFSolver(restricted=False, device=device)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
_, E_hfdmet, _ = dmet.transformResults(
    rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=hf, solver_args={"nelec": nel})
print("IB UHF-DMET    E/cell = %.8f  (identity dE = %.1e)"
      % (E_hfdmet * nsc, abs(E_hfdmet * nsc - meta["E_hf"] / 2)))

mp = MP2(restricted=False, device=device)
rhoMP, EMP = mp.run(ImpHam, nelec=nel, dm0=rho_mf)
_, E_mpdmet, _ = dmet.transformResults(
    rhoMP, EMP, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=mp, solver_args={"nelec": nel})
print("IB UMP2-DMET   E/cell = %.8f  (E_corr/cell = %.6f)"
      % (E_mpdmet * nsc, (E_mpdmet - E_hfdmet) * nsc))
# UCCSD on this embedding needs level_shift >= 0.3 (the bare amplitude
# iteration diverges on the near-degenerate d manifold):
# cc = UCCSD(restricted=False, tol=1e-6, level_shift=0.3, device=device)
