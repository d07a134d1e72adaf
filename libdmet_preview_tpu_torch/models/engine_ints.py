"""
The integral engine's output as plain arrays (the input of the ab initio
lattice builders in models/abinitio.py).

Each ab initio factory takes an EngineInts record: the AO overlap, core
Hamiltonian and ERI of the whole system (a BvK supercell, a ring or a
molecule), its nuclear repulsion and electron count, the atom layout, and
for IAO localization the cross overlap S12 with the minimal reference
basis and that basis' own overlap S2.  mole_engine_ints makes one from the
port's molecular engine (ints.gto.Mole, ints.md.MoleGeneral) and
cell_engine_ints from its periodic engine (ints.pbc.PbcCell).  The .npz
files in libdmet_preview_tpu_torch/data/ hold the records the JAX engine
wrote (scripts/dump_engine_ints_torch.py): the periodic H chain's, which
cell_engine_ints reproduces, and the H ring's, which mole_engine_ints
reproduces.  A cell or molecule keeps its integrals in memory after the
first evaluation; nothing is cached on disk.
"""

import os
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


@dataclass
class EngineInts:
    """Supercell AO integrals of one system.

    S, hcore: (nao, nao); eri: (nao,)*4 chemist (pq|rs); e_nuc: nuclear
    repulsion of the whole system; nelectron: electrons of the whole
    system; natom atoms of nao_atom AOs each, atom-major; ncells: unit
    cells (1 for a molecule), cell-major over the atoms; S12: (nao, nmin)
    cross overlap with the minimal reference basis, S2: (nmin, nmin) its
    overlap (None without IAO data); source: what produced the arrays."""

    S: np.ndarray
    hcore: np.ndarray
    eri: np.ndarray
    e_nuc: float
    nelectron: int
    natom: int
    nao_atom: int
    ncells: int = 1
    S12: Optional[np.ndarray] = None
    S2: Optional[np.ndarray] = None
    source: str = ""

    @property
    def nao(self):
        return self.S.shape[0]

    @property
    def atoms_per_cell(self):
        return self.natom // self.ncells

    @property
    def nmin_atom(self):
        """Minimal-basis functions per atom (needs S2)."""
        return self.S2.shape[0] // self.natom


_SCALARS = {"e_nuc": float, "nelectron": int, "natom": int, "nao_atom": int,
            "ncells": int, "source": str}


def save_engine_ints(path, ints):
    """Write an EngineInts to `path` (.npz)."""
    out = {}
    for f in fields(EngineInts):
        v = getattr(ints, f.name)
        if v is not None:
            out[f.name] = np.asarray(v)
    np.savez_compressed(path, **out)
    return path


def load_engine_ints(path):
    """Read an EngineInts from `path`; a bare file name is looked up in the
    package's data directory."""
    if not os.path.exists(path) and os.path.dirname(path) == "":
        path = os.path.join(DATA_DIR, path)
    with np.load(path, allow_pickle=False) as dat:
        kw = {}
        for f in fields(EngineInts):
            if f.name not in dat:
                continue
            v = dat[f.name]
            kw[f.name] = (_SCALARS[f.name](v[()]) if f.name in _SCALARS
                          else np.array(v, dtype=np.float64))
    return EngineInts(**kw)


def mole_engine_ints(mol, ncells=1, minimal_ref=None):
    """EngineInts of a port molecule (ints.gto.Mole or ints.md.MoleGeneral)
    whose atoms carry equal AO counts, in `ncells` cells, atom-major; with
    `minimal_ref` (an s basis name) also S12 / S2 against that basis on the
    same atoms (IAO localization)."""
    natom = len(mol.atoms)
    S12 = S2 = None
    if minimal_ref is not None:
        from libdmet_preview_tpu_torch.ints.gto import Mole, cross_ovlp
        mol_min = Mole(mol.atoms, basis=minimal_ref)
        S12 = cross_ovlp(mol, mol_min)
        S2 = mol_min.intor_ovlp()
    return EngineInts(
        S=mol.intor_ovlp(), hcore=mol.intor_hcore(), eri=mol.intor_eri(),
        e_nuc=float(mol.energy_nuc()), nelectron=int(mol.nelectron),
        natom=natom, nao_atom=mol.nao // natom, ncells=int(ncells),
        S12=S12, S2=S2,
        source="the port's engine: %d atoms, basis %s%s" % (
            natom, getattr(mol, "basis_name", "general"),
            "" if minimal_ref is None else ", minimal %s" % minimal_ref))


def cell_engine_ints(cell, minimal_ref="minao"):
    """EngineInts of a port PbcCell (ints.pbc; a BvK supercell whose
    set_translations declared its cells, atom-major with equal AO counts
    per atom): S, hcore, the range-separated ERI intor_eri_rs, the Ewald
    energy_nuc, and with `minimal_ref` the periodized cross overlap S12
    against a PbcCell of that basis on the same atoms and torus, and that
    cell's overlap S2 (IAO localization).  The arrays are host NumPy, as
    the .npz records are."""
    from libdmet_preview_tpu_torch.ints.pbc import PbcCell, cross_ovlp_pbc
    from libdmet_preview_tpu_torch.utils.misc import to_host
    natom = len(cell.atoms)
    S12 = S2 = None
    if minimal_ref is not None:
        cell_min = PbcCell(cell.atoms, cell.a, basis=minimal_ref, unit="B",
                           device=cell.device)
        S12 = to_host(cross_ovlp_pbc(cell, cell_min))
        S2 = to_host(cell_min.intor_ovlp())
    return EngineInts(
        S=to_host(cell.intor_ovlp()), hcore=to_host(cell.intor_hcore()),
        eri=to_host(cell.intor_eri_rs()), e_nuc=float(cell.energy_nuc()),
        nelectron=int(cell.nelectron), natom=natom,
        nao_atom=cell.nao // natom, ncells=int(cell.ncells_tr or 1),
        S12=S12, S2=S2,
        source="the port's periodic engine: %d atoms in %d cells, basis "
               "%s%s" % (natom, cell.ncells_tr or 1, cell.basis,
                         "" if minimal_ref is None
                         else ", minimal %s" % minimal_ref))
