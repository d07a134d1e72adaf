#!/usr/bin/env python3
"""
The port's oxide cell integrals, built on the card and written packed, so
that scripts/oxide_reference_jax.py --ints can run the JAX package's
supercell UHF and lattice tail on them on the CPU.

    python3 scripts/oxide_ints_card.py [--kind nio_afm] [--nk 2]
        [--precision 1e-10] [--out chiprun_out/nio_afm_nk2_ints.npz]

It runs the port's factory (workloads.oxide_lattice) on CUDA with its
integral cache in a temporary directory, and writes S, hcore, e_nuc and
the 8-fold packed ERI (eri_s8, of npair * (npair + 1) / 2 elements, npair
= nao * (nao + 1) / 2: 13 MB at nao 60, where the full ERI is 104 MB),
with the port's E_hf and d moments beside them.  It prints the ERI's
largest departure from 8-fold symmetry, the only thing the packing drops.
It imports neither JAX nor the JAX package.
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from libdmet_preview_tpu_torch import workloads as wl  # noqa: E402


def pack_s8(eri):
    """eri[pq, rs] with p >= q, r >= s and pq >= rs, row-major."""
    n = eri.shape[0]
    i, j = np.tril_indices(n)
    s4 = eri[i, j][:, i, j]
    return s4[np.tril_indices(len(i))]


def s8_asymmetry(eri):
    """The largest |eri - eri with one of the 8 index permutations|."""
    perms = ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1))
    return max(float(np.abs(eri - eri.transpose(p)).max()) for p in perms)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=sorted(wl.OXIDE_FACTORIES),
                    default="nio_afm")
    ap.add_argument("--nk", type=int, default=2)
    ap.add_argument("--precision", type=float, default=1e-10)
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "nio_afm_nk2_ints.npz"))
    args = ap.parse_args()
    cache = tempfile.mkdtemp(prefix="oxide_ints_")
    try:
        _, meta = wl.oxide_lattice(args.kind, torch.device("cuda"),
                                   nk=args.nk, precision=args.precision,
                                   cache_file=cache)
        dat = np.load(os.path.join(cache, wl.oxide_cache_name(
            args.kind, args.nk, args.precision)))
        eri = np.asarray(dat["eri"])
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        np.savez(args.out, S=dat["S"], hcore=dat["hcore"],
                 e_nuc=dat["e_nuc"], eri_s8=pack_s8(eri),
                 E_hf=float(meta["E_hf"]),
                 mag_d=np.asarray(meta["mag_d"], dtype=float))
        print("%s nk %d precision %.0e: nao %d, E_hf/cell %.12f, d moments "
              "%s, max ERI departure from 8-fold symmetry %.3e; wrote %s"
              % (args.kind, args.nk, args.precision, eri.shape[0],
                 float(meta["E_hf"]) / args.nk,
                 np.asarray(meta["mag_d"]).tolist(), s8_asymmetry(eri),
                 args.out))
    finally:
        shutil.rmtree(cache, ignore_errors=True)


if __name__ == "__main__":
    main()
