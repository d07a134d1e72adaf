"""
Structure I/O: POSCAR (VASP) and XYZ read/write (PyTorch port of
libdmet_preview_tpu/utils/iotools.py, host only; reference analog:
the reference libdmet's utils/iotools.py:130-280).
"""

import numpy as np

BOHR_PER_ANGSTROM = 1.0 / 0.52917721092


def write_poscar(filename, cell_vectors, symbols, coords_frac,
                 comment="generated by libdmet_preview_tpu_torch"):
    """cell_vectors: (3, 3) Angstrom rows; coords_frac: (natom, 3)."""
    symbols = list(symbols)
    uniq = []
    counts = []
    for s in symbols:
        if not uniq or uniq[-1] != s:
            uniq.append(s)
            counts.append(1)
        else:
            counts[-1] += 1
    with open(filename, "w") as f:
        f.write(comment + "\n1.0\n")
        for v in np.asarray(cell_vectors):
            f.write("  %18.12f %18.12f %18.12f\n" % tuple(v))
        f.write(" ".join(uniq) + "\n")
        f.write(" ".join(str(c) for c in counts) + "\n")
        f.write("Direct\n")
        for r in np.asarray(coords_frac):
            f.write("  %18.12f %18.12f %18.12f\n" % tuple(r))


def read_poscar(filename):
    """Returns (cell_vectors (3,3) Angstrom, symbols list, coords_frac)."""
    with open(filename) as f:
        lines = [l.strip() for l in f.readlines()]
    scale = float(lines[1])
    cell = np.asarray([[float(x) for x in lines[2 + i].split()]
                       for i in range(3)]) * scale
    species = lines[5].split()
    counts = [int(x) for x in lines[6].split()]
    symbols = []
    for s, c in zip(species, counts):
        symbols += [s] * c
    mode = lines[7].lower()
    natom = sum(counts)
    coords = np.asarray([[float(x) for x in lines[8 + i].split()[:3]]
                         for i in range(natom)])
    if mode.startswith("c") or mode.startswith("k"):   # cartesian
        coords = coords @ np.linalg.inv(cell)
    return cell, symbols, coords


def write_xyz(filename, symbols, coords_ang, comment=""):
    with open(filename, "w") as f:
        f.write("%d\n%s\n" % (len(symbols), comment))
        for s, r in zip(symbols, np.asarray(coords_ang)):
            f.write("%-4s %18.12f %18.12f %18.12f\n" % (s, *r))


def read_xyz(filename):
    with open(filename) as f:
        lines = f.readlines()
    natom = int(lines[0])
    symbols, coords = [], []
    for l in lines[2:2 + natom]:
        w = l.split()
        symbols.append(w[0])
        coords.append([float(x) for x in w[1:4]])
    return symbols, np.asarray(coords)
