#!/usr/bin/env python3
"""
The JAX package's diamond values that the PyTorch port is held to
(libdmet_preview_tpu_torch/workloads.py: DIAMOND_JAX).

    JAX_PLATFORMS=cpu python scripts/diamond_reference_jax.py [--case NAME]

It builds diamond with the JAX package's factories, make_diamond_lattice
(the nk-cell chain on the Cholesky format, tests/test_diamond.py) and
make_diamond_lattice3 (the 3D k-mesh on the 'aft' format with the
range-separated driver, tests/test_diamond333.py), and runs the protocol
of tests/test_diamond333.py:39-93 (workloads.DIAMOND_PROTOCOL): per cell
the supercell RHF, the lattice mean field, the IB-HF identity and the
one-shot DMET(CCSD) energies and the impurity electron count, and for the
3D factory the energies of the self-consistent CCSD loop.  Cases:

  tier1_chain, tier1_mesh  the arguments of the CPU tests
                           (workloads.DIAMOND_TIER1), a few minutes;
  chain_nk2                make_diamond_lattice(nk=2) at its defaults
                           (precision 1e-12): the JAX package's
                           single-threaded short-range ERI rows take
                           about an hour on a CPU;
  mesh221_hf               make_diamond_lattice3 on a 2 x 2 x 1 mesh at
                           precision 1e-4, E_hf only (a 3D translation
                           group), ~4 min.

It prints the DIAMOND_JAX entries to paste into workloads.py; with
--port it also runs the port's factory on the CPU on each case and prints
its values beside them.  This is a developer tool: it imports
libdmet_preview_tpu (the port never does).
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


def _nelec(Lat, basis):
    from libdmet_preview_tpu.ops import embham
    rho_mf = np.asarray(embham.foldRho_k(Lat.rdm1_lo_k,
                                         Lat.R2k_basis(basis)))
    nel = int(round(np.trace(rho_mf[0])))
    return nel + nel % 2


def one_shot(Lat, meta):
    """tests/test_diamond333.py:49-67 and the one-shot CCSD."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import CCSD, SCFSolver
    nsc = Lat.nscsites
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    rho, _, res = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                              matching=False, int_bath=True)
    nel = _nelec(Lat, basis)
    out = {"E_hf": float(meta["E_hf"]) / Lat.ncells,
           "E_mf": float(res["E"]), "nelec_emb": nel}
    hf = SCFSolver(restricted=True)
    rhoEmb, EEmb = hf.run(ImpHam, nelec=nel)
    _, E, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                    lattice=Lat, last_dmu=0.0,
                                    int_bath=True, solver=hf,
                                    solver_args={"nelec": nel})
    out["E_ibhf"] = float(E) * nsc
    cc = CCSD(restricted=True, tol=wl.DIAMOND_PROTOCOL["cc_tol"])
    rhoEmb, EEmb = cc.run(ImpHam, nelec=nel)
    _, E, n = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                    lattice=Lat, last_dmu=0.0,
                                    int_bath=True, solver=cc,
                                    solver_args={"nelec": nel})
    out["E_cc"] = float(E) * nsc
    out["n_cc"] = float(n)
    return out


def loop(Lat, proto=wl.DIAMOND_PROTOCOL):
    """tests/test_diamond333.py:69-93 (workloads.run_diamond_dmet)."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops.diis import DIIS
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.solvers import CCSD
    nsc = Lat.nscsites
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    cc = CCSD(restricted=True, tol=proto["cc_tol"])
    adiis = DIIS(space=proto["diis_space"])
    E_old, Es, conv = None, [], False
    for it in range(proto["max_iter"]):
        rho, _, _ = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        nel = _nelec(Lat, basis)
        rhoEmb, EEmb = cc.run(ImpHam, nelec=nel)
        _, E, n = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                        lattice=Lat, last_dmu=0.0,
                                        int_bath=True, solver=cc,
                                        solver_args={"nelec": nel})
        vcor_new, _ = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf, 0.5,
                                   MaxIter1=proto["fit_iter"], MaxIter2=0)
        p_new = np.hstack(vcor_new.param)
        dV = np.max(np.abs(p_new - np.hstack(vcor.param)))
        dE = abs(float(E) * nsc - E_old) if E_old is not None else np.inf
        vcor.update(np.asarray(adiis.update(p_new)
                               if it >= proto["diis_from"] else p_new))
        E_old = float(E) * nsc
        Es.append(E_old)
        if dE < proto["e_tol"] and dV < proto["v_tol"]:
            conv = True
            break
    return {"loop": Es, "loop_n": float(n), "loop_converged": conv}


CASES = {
    "tier1_chain": ("make_diamond_lattice", wl.DIAMOND_TIER1["chain"]),
    "tier1_mesh": ("make_diamond_lattice3", wl.DIAMOND_TIER1["mesh"]),
    "chain_nk2": ("make_diamond_lattice", {"nk": 2}),
    "mesh221_hf": ("make_diamond_lattice3",
                   {"kmesh": (2, 2, 1), "precision": 1e-4}),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=sorted(CASES), action="append")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from libdmet_preview_tpu.models import abinitio
    from libdmet_preview_tpu.ints import pbc
    cell_cls = pbc.PbcCell
    for case in args.case or ["tier1_chain", "tier1_mesh"]:
        fn, kw = CASES[case]
        kw = dict(kw)
        if fn == "make_diamond_lattice" and "precision" in kw:
            # the JAX chain factory takes the cell's default precision:
            # give its cell the port factory's precision= argument
            prec = kw.pop("precision")

            class _Cell(cell_cls):
                def __init__(self, *a, **k):
                    k.setdefault("precision", prec)
                    super().__init__(*a, **k)
            pbc.PbcCell = _Cell
        t0 = time.time()
        try:
            Lat, meta = getattr(abinitio, fn)(**kw)
        finally:
            pbc.PbcCell = cell_cls
        t1 = time.time()
        if case.endswith("_hf"):
            out = {"E_hf": float(meta["E_hf"]) / Lat.ncells}
        else:
            out = one_shot(Lat, meta)
            if fn == "make_diamond_lattice3":
                out.update(loop(Lat))
        print("# %s: build %.1f s, protocol %.1f s" % (
            case, t1 - t0, time.time() - t1))
        print("    %r: %r," % (case, out), flush=True)
        if args.port:
            import torch
            from libdmet_preview_tpu_torch.models import abinitio as tab
            cpu = torch.device("cpu")
            Lat_t, meta_t = getattr(tab, fn)(device=cpu, **CASES[case][1])
            port = {"E_hf": float(meta_t["E_hf"]) / Lat_t.ncells}
            if not case.endswith("_hf"):
                res = wl.diamond_one_shot(Lat_t, meta_t, cpu)
                port.update({k: res[k] for k in out if k in res})
            print("# port %s: %r" % (case, port), flush=True)


if __name__ == "__main__":
    main()
