#!/usr/bin/env python3
"""
Seconds of the periodic cell's short-range ERI rows (PbcCell._sr_rows, the
native core csrc/_sr_core.cpp erfc_eri_rows_batch) for the diamond
supercell of models/abinitio.diamond_cell, on a given number of host
threads:

    python scripts/time_sr_rows.py --kmesh 1 1 2 --precision 1e-12 \\
        --omega 1.0 --threads 8 [--jax]

With --jax it also times the JAX package's _sr_ao_eri_rows on the same
cell (one thread: its core has no threads) and prints the largest
difference of the two.  A developer tool: --jax imports
libdmet_preview_tpu (the port never does).  Host seconds: they depend on
the machine and on what else runs on it.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kmesh", type=int, nargs=3, default=(1, 1, 2))
    ap.add_argument("--precision", type=float, default=1e-12)
    ap.add_argument("--omega", type=float, default=1.0)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    from libdmet_preview_tpu_torch.ints import native
    from libdmet_preview_tpu_torch.models.abinitio import diamond_cell
    cell = diamond_cell(tuple(args.kmesh), precision=args.precision,
                        device="cpu")
    native.get_sr_lib()
    nt = native.num_threads() if args.threads is None else args.threads
    t0 = time.perf_counter()
    rows = cell._sr_rows(args.omega, args.precision, nthreads=nt)
    print("port: kmesh %s, precision %.0e, omega %.2f, %d threads: %.2f s"
          % (tuple(args.kmesh), args.precision, args.omega, nt,
             time.perf_counter() - t0))
    if args.jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from libdmet_preview_tpu.ints.pbc import PbcCell
        jc = PbcCell(cell.atoms, cell.a, basis=cell.basis, unit="B",
                     pseudo=cell.pseudo, precision=args.precision)
        jc.set_translations(cell.ncells_tr, cell.t_vecs)
        t0 = time.perf_counter()
        ref = jc._sr_ao_eri_rows(args.omega)
        print("JAX: %.2f s, max |port - JAX| %.3e (max |JAX| %.3e)"
              % (time.perf_counter() - t0, np.abs(rows - ref).max(),
                 np.abs(ref).max()))


if __name__ == "__main__":
    main()
