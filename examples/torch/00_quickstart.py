#!/usr/bin/env python
"""
Quickstart: self-consistent DMET in one call, on the PyTorch port.

1D Hubbard chain (18 sites, U/t = 4, half filling, 2-site impurity),
FCI impurity solver, non-interacting bath.  Reproduces the reference
energy per site -0.5527339 (gkclab/libdmet_preview's own integration
test value) in ~15 iterations.

Run: python examples/torch/00_quickstart.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import libdmet_preview_tpu_torch.dmet.hubbard as dmet  # noqa: E402
from libdmet_preview_tpu_torch.dmet.loop import run_dmet  # noqa: E402
from libdmet_preview_tpu_torch.utils.config import DmetConfig  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)

Lat = dmet.ChainLattice(18, 2)
Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True, device=device)
vcor = dmet.PMInitGuess([2], 4.0, 0.5)

res = run_dmet(Lat, vcor,
               DmetConfig(filling=0.5, restricted=False, int_bath=False,
                          solver="FCI", max_iter=25))

print("converged        :", res.converged)
print("energy per site  : %.9f  (reference -0.552733945)" % res.e_per_site)
print("impurity filling : %.6f" % res.nelec_imp)
print("iterations       : %d" % len(res.history))
