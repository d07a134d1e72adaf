"""
The integral engine's output as plain arrays (the input of the ab initio
lattice builders in models/abinitio.py).

The port has no Gaussian integral engine yet, so each ab initio factory
takes an EngineInts record: the AO overlap, core Hamiltonian and ERI of
the whole system (a BvK supercell, a ring or a molecule), its nuclear
repulsion and electron count, the atom layout, and for IAO localization
the cross overlap S12 with the minimal reference basis and that basis'
own overlap S2.  Records are kept as .npz files; the ones the repo ships
live in libdmet_preview_tpu_torch/data/ and are written by
scripts/dump_engine_ints_torch.py.
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
