#!/usr/bin/env python3
"""
The JAX package's periodic-engine values on the H chain that the PyTorch
port's chip_smoke.py phase 14 is held to (libdmet_preview_tpu_torch/
workloads.py: PBC_JAX).

    JAX_PLATFORMS=cpu python scripts/pbc_reference_jax.py [--nk 6]

It builds the H chain of workloads.HCHAIN_CELL at nk k-points with the JAX
package (make_hchain_pbc_lattice: make_hchain_supercell, the
range-separated ERI, RHF, IAO + PAO against MINAO), records the Ewald
energy, the supercell RHF energy and the Frobenius norms of the AO
overlap, core Hamiltonian and ERI, runs the interacting-bath FCI loop of
tests/test_hchain_pbc.py:106-158 with the protocol of
workloads.IB_PROTOCOL, and prints the PBC_JAX entry to paste into
workloads.py.  This is a developer tool: it imports libdmet_preview_tpu
(the port never does).  At nk = 6 it takes a few minutes on a CPU and
about 6 GB of memory, most of it the pair Fourier transform of the
long-range mesh (485,875 G vectors x 24 x 24 complex).
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


def jax_ib_loop(Lat, meta, proto):
    """tests/test_hchain_pbc.py:106-158 with the protocol's iterations,
    fit steps, fit ytol and stops (the port's workloads.run_hchain_dmet).
    Returns (E_cell, iterations)."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.models.abinitio import update_ham_dense
    from libdmet_preview_tpu.ops.diis import DIIS
    from libdmet_preview_tpu.ops.fit import make_vcor_trace_unchanged
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import FCI
    nsc = Lat.nscsites
    filling = 6 / (nsc * 2.0 * 3)
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    solver = FCI(restricted=True, tol=1e-12)
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=4)
    Mu, last_dmu, E_old, E_cell = 0.0, 0.0, 0.0, None
    for it in range(proto["max_iter"]):
        rho, Mu, _ = dmet.RHartreeFock(Lat, vcor, filling, Mu, ires=True)
        update_ham_dense(Lat, meta, np.asarray(rho)[0] * 2.0)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, filling, ImpHam, basis, solver, solver_args,
            thrnelec=1e-6, delta=0.01, step=0.1)
        last_dmu += dmu
        _, EnergyImp, _ = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        E_cell = float(EnergyImp) * nsc
        vcor_new, _ = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf,
                                   filling, MaxIter1=proto["fit_iter"],
                                   MaxIter2=0, ytol=proto["ytol"],
                                   gtol=1e-4)
        if it >= 3:
            vcor_new = make_vcor_trace_unchanged(vcor_new, vcor)
        pvcor = np.hstack(vcor_new.param)
        if it >= 4:
            pvcor = adiis.update(pvcor)
        dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
        vcor.update(pvcor)
        dE, E_old = E_cell - E_old, E_cell
        print("  iteration %d: E/cell %.12f dV %.3e dE %.3e"
              % (it, E_cell, dV, dE), flush=True)
        if dV < proto["u_tol"] and abs(dE) < proto["e_tol"] and it > 4:
            break
    return E_cell, it + 1


def reference(nk):
    import jax
    jax.config.update("jax_enable_x64", True)
    from libdmet_preview_tpu.models.abinitio import make_hchain_pbc_lattice
    c = wl.HCHAIN_CELL
    t0 = time.time()
    Lat, meta = make_hchain_pbc_lattice(nk=nk, nH=c["nH"], R=c["R"],
                                        vac=c["vac"], basis=c["basis"])
    print("lattice built in %.1f s" % (time.time() - t0), flush=True)
    cell = meta["cell"]
    S = cell.intor_ovlp()
    hcore = cell.intor_hcore()
    eri = cell.intor_eri_rs()
    out = {"nao": int(cell.nao), "e_nuc": float(cell.energy_nuc()),
           "E_hf": float(meta["E_hf"]),
           "S_fro": float(np.linalg.norm(S)),
           "hcore_fro": float(np.linalg.norm(hcore)),
           "eri_fro": float(np.linalg.norm(eri.reshape(-1)))}
    t0 = time.time()
    out["E_ib_fci"], out["iterations"] = jax_ib_loop(Lat, meta,
                                                     wl.IB_PROTOCOL)
    print("IB FCI loop in %.1f s" % (time.time() - t0), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nk", type=int, default=wl.HCHAIN_FULL_NK)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = reference(args.nk)
    print("PBC_JAX = {%d: {" % args.nk)
    for k, v in out.items():
        print("    %r: %r," % (k, v))
    print("}}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
