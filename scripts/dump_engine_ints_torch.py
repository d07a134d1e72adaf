#!/usr/bin/env python3
"""
Write the engine-array files that the PyTorch port's ab initio lattice
builders read (libdmet_preview_tpu_torch/data/*.npz), from the JAX
package's native Gaussian integral engine.

    JAX_PLATFORMS=cpu python scripts/dump_engine_ints_torch.py [--check]

With --check nothing is written: each file's arrays are rebuilt and
compared with the file (1e-12), and the exit code says whether they agree.
This is a developer tool; it imports libdmet_preview_tpu (host engine
only), the port never does.  The H chain's supercell integrals take about
a minute; they are read from LIBDMET_TPU_INT_CACHE when it names a
directory that holds them.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from libdmet_preview_tpu_torch.models.engine_ints import (  # noqa: E402
    DATA_DIR, EngineInts, load_engine_ints, save_engine_ints)


def hchain_ints(nk=3, nH=2, R=1.5, vac=10.0, basis="3-21g",
                minao_ref="minao"):
    """The periodic H chain of models/abinitio.make_hchain_pbc_lattice:
    BvK supercell of nk cells of nH atoms, Ewald-periodized integrals, and
    the periodized minimal reference basis for the IAOs."""
    from libdmet_preview_tpu.ints.pbc import (make_hchain_supercell,
                                              cross_ovlp_pbc, PbcCell)
    from libdmet_preview_tpu.models.abinitio import _cell_ints_cached
    cell = make_hchain_supercell(nk=nk, nH=nH, R=R, vac=vac, basis=basis)
    S, hcore, eri, e_nuc = _cell_ints_cached(
        cell, "hchain", (nk, nH, R, vac, basis, None))
    cell_min = PbcCell(cell.atoms, cell.a, basis=minao_ref, unit="B")
    natom = nk * nH
    return EngineInts(
        S=S, hcore=hcore, eri=eri, e_nuc=float(e_nuc),
        nelectron=int(cell.nelectron), natom=natom,
        nao_atom=cell.nao // natom, ncells=nk,
        S12=cross_ovlp_pbc(cell, cell_min), S2=cell_min.intor_ovlp(),
        source="libdmet_preview_tpu ints.pbc make_hchain_supercell(nk=%d, "
               "nH=%d, R=%g, vac=%g, basis=%s), minimal %s"
               % (nk, nH, R, vac, basis, minao_ref))


def hring_ints(ncells=3, atoms_per_cell=2, r_bond=1.8, basis="sto-6g",
               minimal_ref="sto-6g"):
    """The H ring of models/abinitio.make_h_ring_lattice (bohr)."""
    from libdmet_preview_tpu.ints.gto import Mole, h_ring, cross_ovlp
    natom = ncells * atoms_per_cell
    atoms = h_ring(natom, r_bond)
    mol = Mole(atoms, basis=basis)
    mol_min = Mole(atoms, basis=minimal_ref)
    return EngineInts(
        S=mol.intor_ovlp(), hcore=mol.intor_hcore(), eri=mol.intor_eri(),
        e_nuc=float(mol.energy_nuc()), nelectron=int(mol.nelectron),
        natom=natom, nao_atom=mol.nao // natom, ncells=ncells,
        S12=cross_ovlp(mol, mol_min), S2=mol_min.intor_ovlp(),
        source="libdmet_preview_tpu ints.gto Mole(h_ring(%d, %g), "
               "basis=%s), minimal %s" % (natom, r_bond, basis,
                                          minimal_ref))


# file name -> builder of its arrays
FILES = {
    "hchain_nk3_nH2_R1.5_vac10_3-21g.npz":
        lambda: hchain_ints(nk=3, nH=2, R=1.5, vac=10.0, basis="3-21g"),
    "hring_3x2_r1.8_sto-6g.npz":
        lambda: hring_ints(3, 2, 1.8, basis="sto-6g"),
    "hring_3x2_r1.8_3-21g.npz":
        lambda: hring_ints(3, 2, 1.8, basis="3-21g"),
}

ARRAYS = ("S", "hcore", "eri", "S12", "S2")
SCALARS = ("e_nuc", "nelectron", "natom", "nao_atom", "ncells")


def max_diff(a, b):
    """Largest difference between two EngineInts (inf on a layout
    mismatch)."""
    err = 0.0
    for k in SCALARS:
        err = max(err, abs(float(getattr(a, k)) - float(getattr(b, k))))
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None):
            return np.inf
        if x is not None:
            if x.shape != y.shape:
                return np.inf
            err = max(err, float(np.abs(x - y).max()))
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the files with a rebuild, write nothing")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    bad = []
    for name, build in FILES.items():
        path = os.path.join(DATA_DIR, name)
        ints = build()
        if args.check:
            err = max_diff(ints, load_engine_ints(path))
            print("%s: max |file - engine| = %.3e" % (name, err))
            if not err <= 1e-12:
                bad.append(name)
        else:
            os.makedirs(DATA_DIR, exist_ok=True)
            save_engine_ints(path, ints)
            print("wrote %s (%d bytes)" % (path, os.path.getsize(path)))
    if bad:
        print("stale engine-array files: %s" % ", ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
