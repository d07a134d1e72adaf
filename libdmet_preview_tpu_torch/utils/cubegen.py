"""
Gaussian cube files for orbitals and densities (PyTorch port of
libdmet_preview_tpu/utils/cubegen.py; host NumPy over the port's
Gaussian engine, ints.gto.Mole and ints.md.MoleGeneral)."""

import numpy as np


def eval_ao(mol, coords):
    """AO values on a set of points.  mol: ints.gto.Mole (s shells) or
    ints.md.MoleGeneral (arbitrary Cartesian l).
    coords: (npts, 3) bohr.  Returns (npts, nao)."""
    coords = np.asarray(coords)
    out = np.zeros((len(coords), mol.nao))
    if hasattr(mol, "shell_slices"):        # general-l MoleGeneral
        from libdmet_preview_tpu_torch.ints.md import CART
        for sh, (i0, i1) in zip(mol.shells, mol.shell_slices):
            d = coords - sh.center
            r2 = np.sum(d * d, axis=1)
            rad = np.zeros(len(coords))
            for alpha, c in zip(sh.exps, sh.coefs):
                rad += c * np.exp(-alpha * r2)
            for comp, (l, m, n) in enumerate(CART[sh.l]):
                out[:, i0 + comp] = (d[:, 0] ** l) * (d[:, 1] ** m) \
                    * (d[:, 2] ** n) * rad
        return out
    for i, (center, prim) in enumerate(mol.shells):
        r2 = np.sum((coords - center) ** 2, axis=1)
        for alpha, c in prim:
            out[:, i] += c * np.exp(-alpha * r2)
    return out


def _grid(mol, nx, ny, nz, margin=4.0):
    lo = mol.coords.min(axis=0) - margin
    hi = mol.coords.max(axis=0) + margin
    xs = [np.linspace(lo[d], hi[d], n) for d, n in
          enumerate((nx, ny, nz))]
    mesh = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1)
    steps = [(hi[d] - lo[d]) / max(n - 1, 1) for d, n in
             enumerate((nx, ny, nz))]
    return lo, steps, mesh.reshape(-1, 3)


def write_cube(filename, mol, data, lo, steps, shape,
               comment="libdmet_preview_tpu_torch cube"):
    nx, ny, nz = shape
    with open(filename, "w") as f:
        f.write(comment + "\n generated cube\n")
        f.write("%5d %11.6f %11.6f %11.6f\n" % (len(mol.atoms), *lo))
        f.write("%5d %11.6f %11.6f %11.6f\n" % (nx, steps[0], 0, 0))
        f.write("%5d %11.6f %11.6f %11.6f\n" % (ny, 0, steps[1], 0))
        f.write("%5d %11.6f %11.6f %11.6f\n" % (nz, 0, 0, steps[2]))
        for Z, r in zip(mol.charges, mol.coords):
            f.write("%5d %11.6f %11.6f %11.6f %11.6f\n" % (int(Z), Z, *r))
        vals = np.asarray(data).reshape(nx, ny, nz)
        for ix in range(nx):
            for iy in range(ny):
                row = vals[ix, iy]
                for k in range(0, nz, 6):
                    f.write("".join("%13.5e" % v for v in row[k:k + 6])
                            + "\n")


def orbital(mol, filename, coeff, nx=40, ny=40, nz=40, margin=4.0):
    """Write one molecular orbital (AO coefficient vector) as a cube."""
    lo, steps, pts = _grid(mol, nx, ny, nz, margin)
    ao = eval_ao(mol, pts)
    write_cube(filename, mol, ao @ np.asarray(coeff), lo, steps,
               (nx, ny, nz))


def density(mol, filename, dm, nx=40, ny=40, nz=40, margin=4.0):
    """Write the electron density of an AO-basis density matrix."""
    lo, steps, pts = _grid(mol, nx, ny, nz, margin)
    ao = eval_ao(mol, pts)
    rho = np.einsum("xi, ij, xj -> x", ao, np.asarray(dm), ao)
    write_cube(filename, mol, rho, lo, steps, (nx, ny, nz))
    return rho
