#!/usr/bin/env python3
"""
The JAX package's KS-DFT and DFT-in-DMET values on the H ring that the
PyTorch port's chip_smoke.py phase 13 is held to
(libdmet_preview_tpu_torch/workloads.py: DFT_JAX).

    JAX_PLATFORMS=cpu python scripts/dft_reference_jax.py [--natom 22]

For each functional of workloads.DFT_XC it builds the ring of
workloads.DFT_RING with the JAX package (make_h_ring_lattice, IAO + PAO),
runs attach_ks (the molecular RKS at the default grid) and the
DFT-in-DMET loop of tests/test_dft.py:139-182 with the protocol of
workloads.DFT_DMET, and prints the DFT_JAX dictionary to paste into
workloads.py.  This is a developer tool: it imports libdmet_preview_tpu
(the port never does) and takes a few minutes per functional at 22 atoms
on a CPU, most of it the JAX package's host Becke partition.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from libdmet_preview_tpu_torch import workloads as wl  # noqa: E402


def jax_dft_dmet(natom, xc):
    import jax
    jax.config.update("jax_enable_x64", True)
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.models.abinitio import (attach_ks,
                                                     make_h_ring_lattice)
    from libdmet_preview_tpu.solvers import FCI
    ring = wl.DFT_RING
    apc = ring["atoms_per_cell"]
    t0 = time.time()
    Lat, meta = make_h_ring_lattice(
        natom // apc, atoms_per_cell=apc, r_bond=ring["r_bond"],
        basis=ring["basis"], localization="iao",
        minimal_ref=ring["minimal_ref"])
    nlo = meta["nlo"]
    cycles = []
    from libdmet_preview_tpu.solvers import ksdft
    plain = ksdft.RKS._plus_u

    def counted(self, dm):
        cycles.append(1)
        return plain(self, dm)
    ksdft.RKS._plus_u = counted
    try:
        ks = attach_ks(Lat, meta, xc=xc)
    finally:
        ksdft.RKS._plus_u = plain
    rho_g = np.einsum("pg, pq, qg -> g", ks.ao_g, ks.dm, ks.ao_g)
    n_grid = float(np.sum(ks.grid[1] * rho_g))
    t_ks = time.time() - t0
    vcor = dmet.VcorLocal(True, False, nlo)
    vcor.update(np.zeros(vcor.length()))
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    rho, mu = dmet.RHartreeFock(Lat, vcor, filling, None)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                              int_bath=True)
    solver = FCI(restricted=True, tol=1e-12)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    last_dmu = 0.0
    for it in range(wl.DFT_DMET["max_iter"]):
        rhoEmb, E_emb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        rhoImp, EnergyImp, nelecImp = dmet.transformResults(
            rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        if abs(nelecImp - 2 * filling) < wl.DFT_DMET["nelec_tol"]:
            break
    # RKS kernel calls _plus_u once per SCF iteration and once at the end
    return {"E_ks": float(ks.e_tot), "ks_cycles": len(cycles) - 1,
            "n_grid": n_grid, "E": float(EnergyImp) * nlo,
            "nelecImp": float(nelecImp),
            "rhoImp": np.asarray(rhoImp).tolist(), "steps": it + 1,
            "neo": int(np.asarray(basis).shape[-1]),
            "seconds": (t_ks, time.time() - t0)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--natom", type=int, default=wl.DFT_NATOM_JAX)
    args = ap.parse_args()
    out = {}
    for xc in wl.DFT_XC:
        r = jax_dft_dmet(args.natom, xc)
        print("# %s: KS %.1f s, total %.1f s" % ((xc,) + r.pop("seconds")),
              flush=True)
        out[xc] = r
    print("DFT_JAX = {")
    for xc, r in out.items():
        print("    %r: {" % xc)
        for k, v in r.items():
            if k == "rhoImp":
                print("        %r: %s," % (k, np.array2string(
                    np.asarray(v), separator=", ", precision=17,
                    floatmode="unique", threshold=10 ** 6).replace(
                        "\n", "\n" + " " * 12)))
            else:
                print("        %r: %r," % (k, v))
        print("    },")
    print("}")


if __name__ == "__main__":
    main()
