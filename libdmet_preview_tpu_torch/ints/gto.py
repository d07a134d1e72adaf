"""
Gaussian integral engine for contracted s-type orbitals (PyTorch port of
libdmet_preview_tpu/ints/gto.py; host NumPy, as in the JAX package).

Closed-form McMurchie-Davidson expressions for s shells (STO-3G, STO-6G,
3-21G and MINAO on hydrogen are pure s): overlap, kinetic, nuclear
attraction and ERIs through the Boys function F0.  AO integrals are
inputs of the device path, computed once per geometry: a Mole keeps each
one-electron matrix after its first evaluation and hands out copies.  The
ERI runs in the native C++ core (ints/native.py, csrc/_gto_core.cpp) when
g++ can build it, else in the NumPy loop eri_s_numpy.

All quantities in atomic units (bohr, hartree).
"""

import numpy as np
from scipy.special import erf


# ----------------------------------------------------------------------
# basis library (s-only; exponents/coefficients are standard public data)
# ----------------------------------------------------------------------

BASIS = {
    ("H", "sto-3g"): [
        # [(exp, coeff), ...] one contracted s shell
        [(3.42525091, 0.15432897), (0.62391373, 0.53532814),
         (0.16885540, 0.44463454)],
    ],
    ("H", "sto-6g"): [
        [(35.52322122, 0.00916359628), (6.513143725, 0.04936149294),
         (1.822142904, 0.16853830490), (0.625955266, 0.37056279970),
         (0.243076747, 0.41649152980), (0.100112428, 0.13033408410)],
    ],
    ("H", "3-21g"): [
        [(5.447178, 0.156285), (0.824547, 0.904691)],
        [(0.183192, 1.0)],
    ],
    ("He", "sto-3g"): [
        [(6.36242139, 0.15432897), (1.15892300, 0.53532814),
         (0.31364979, 0.44463454)],
    ],
    # PySCF's MINAO reference basis for H (the cc-pVTZ occupied s
    # contraction) -- the minimal reference the reference code's IAO
    # construction uses by default (reference lo/iao.py:47 MINAO)
    ("H", "minao"): [
        [(33.87, 0.0060680), (5.095, 0.0453080), (1.159, 0.2028220),
         (0.3258, 0.5039030), (0.1027, 0.3834210)],
    ],
}

CHARGES = {"H": 1.0, "He": 2.0, "Li": 3.0, "Be": 4.0, "B": 5.0, "C": 6.0,
           "N": 7.0, "O": 8.0, "F": 9.0, "Ne": 10.0, "Na": 11.0,
           "Mg": 12.0, "Al": 13.0, "Si": 14.0, "P": 15.0, "S": 16.0,
           "Cl": 17.0, "Ti": 22.0, "V": 23.0, "Cr": 24.0, "Mn": 25.0,
           "Fe": 26.0, "Co": 27.0, "Ni": 28.0, "Cu": 29.0, "Zn": 30.0}


def _norm_s(alpha):
    """Normalization of a primitive s Gaussian."""
    return (2.0 * alpha / np.pi) ** 0.75


class Mole(object):
    """Minimal molecule: atoms [(symbol, xyz_bohr)], s-only basis."""

    def __init__(self, atoms, basis="sto-6g"):
        self.atoms = [(sym, np.asarray(xyz, dtype=float))
                      for sym, xyz in atoms]
        self.basis_name = basis
        # flatten shells -> AO list of (center, [(exp, normed coeff)])
        self.shells = []
        for sym, xyz in self.atoms:
            for shell in BASIS[(sym, basis)]:
                prim = [(a, c * _norm_s(a)) for a, c in shell]
                # normalize the contracted function
                s = 0.0
                for a1, c1 in prim:
                    for a2, c2 in prim:
                        s += c1 * c2 * (np.pi / (a1 + a2)) ** 1.5
                prim = [(a, c / np.sqrt(s)) for a, c in prim]
                self.shells.append((xyz, prim))
        self.nao = len(self.shells)
        self.charges = np.asarray([CHARGES[sym] for sym, _ in self.atoms])
        self.coords = np.asarray([xyz for _, xyz in self.atoms])
        self.nelectron = int(self.charges.sum())
        self._cache = {}

    def _cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key].copy()

    # ------------------------------------------------------------------
    def energy_nuc(self):
        e = 0.0
        for i in range(len(self.atoms)):
            for j in range(i):
                r = np.linalg.norm(self.coords[i] - self.coords[j])
                e += self.charges[i] * self.charges[j] / r
        return e

    def _pairs(self):
        """All primitive pair data per AO pair, vectorized arrays."""
        nao = self.nao
        exps = [np.asarray([p[0] for p in sh[1]]) for sh in self.shells]
        cofs = [np.asarray([p[1] for p in sh[1]]) for sh in self.shells]
        cens = [sh[0] for sh in self.shells]
        return exps, cofs, cens

    def intor_ovlp(self):
        return self._cached("ovlp", self._ovlp)

    def intor_kin(self):
        return self._cached("kin", self._kin)

    def intor_nuc(self):
        return self._cached("nuc", self._nuc)

    def _ovlp(self):
        exps, cofs, cens = self._pairs()
        nao = self.nao
        S = np.zeros((nao, nao))
        for i in range(nao):
            for j in range(i + 1):
                a = exps[i][:, None]
                b = exps[j][None, :]
                p = a + b
                AB2 = np.sum((cens[i] - cens[j]) ** 2)
                val = (np.pi / p) ** 1.5 * np.exp(-a * b / p * AB2)
                S[i, j] = S[j, i] = np.sum(
                    cofs[i][:, None] * cofs[j][None, :] * val)
        return S

    def _kin(self):
        exps, cofs, cens = self._pairs()
        nao = self.nao
        T = np.zeros((nao, nao))
        for i in range(nao):
            for j in range(i + 1):
                a = exps[i][:, None]
                b = exps[j][None, :]
                p = a + b
                mu = a * b / p
                AB2 = np.sum((cens[i] - cens[j]) ** 2)
                sval = (np.pi / p) ** 1.5 * np.exp(-mu * AB2)
                tval = mu * (3.0 - 2.0 * mu * AB2) * sval
                T[i, j] = T[j, i] = np.sum(
                    cofs[i][:, None] * cofs[j][None, :] * tval)
        return T

    def _nuc(self):
        exps, cofs, cens = self._pairs()
        nao = self.nao
        V = np.zeros((nao, nao))
        for i in range(nao):
            for j in range(i + 1):
                a = exps[i][:, None]
                b = exps[j][None, :]
                p = a + b
                mu = a * b / p
                AB2 = np.sum((cens[i] - cens[j]) ** 2)
                P = (a[..., None] * cens[i] + b[..., None] * cens[j]) / p[..., None]
                pref = -2.0 * np.pi / p * np.exp(-mu * AB2)
                # all nuclei at once: (nprim_i, nprim_j, natom)
                PC2 = np.sum((P[..., None, :] - self.coords) ** 2, axis=-1)
                acc = np.sum(self.charges * pref[..., None]
                             * boys0(p[..., None] * PC2), axis=-1)
                V[i, j] = V[j, i] = np.sum(
                    cofs[i][:, None] * cofs[j][None, :] * acc)
        return V

    def intor_hcore(self):
        return self.intor_kin() + self.intor_nuc()

    def intor_eri(self):
        """Full (nao,)*4 chemist ERI tensor (s-only, 8-fold symmetric):
        the native C++ core when it loads, else eri_s_numpy."""
        return self._cached("eri", self._eri)

    def _eri(self):
        from libdmet_preview_tpu_torch.ints import native
        out = native.eri_s_shells(self.shells)
        if out is not None:
            return out
        return eri_s_numpy(self.shells)


def eri_s_numpy(shells):
    """The NumPy ERI loop over contracted s shells [(center_xyz, [(exp,
    coeff), ...]), ...]: (nao,)*4, one primitive-pair table per AO pair
    and 8-fold symmetry (what the native core computes)."""
    exps = [np.asarray([p[0] for p in sh[1]]) for sh in shells]
    cofs = [np.asarray([p[1] for p in sh[1]]) for sh in shells]
    cens = [sh[0] for sh in shells]
    nao = len(shells)
    eri = np.zeros((nao,) * 4)
    # precompute pair quantities
    pair = {}
    for i in range(nao):
        for j in range(i + 1):
            a = exps[i][:, None]
            b = exps[j][None, :]
            p = (a + b).ravel()
            c12 = (cofs[i][:, None] * cofs[j][None, :]).ravel()
            AB2 = np.sum((cens[i] - cens[j]) ** 2)
            K = (np.exp(-(a * b / (a + b)) * AB2)).ravel()
            P = ((a[..., None] * cens[i] + b[..., None] * cens[j])
                 / (a + b)[..., None]).reshape(-1, 3)
            pair[(i, j)] = (p, c12 * K, P)

    done = set()
    for i in range(nao):
        for j in range(i + 1):
            for k in range(nao):
                for l in range(k + 1):
                    if (k, l, i, j) in done:
                        continue
                    p, cK1, P = pair[(i, j)]
                    q, cK2, Q = pair[(k, l)]
                    pp = p[:, None]
                    qq = q[None, :]
                    denom = pp + qq
                    PQ2 = np.sum((P[:, None, :] - Q[None, :, :]) ** 2,
                                 axis=-1)
                    val = (2.0 * np.pi ** 2.5
                           / (pp * qq * np.sqrt(denom))
                           * boys0(pp * qq / denom * PQ2))
                    v = np.sum(cK1[:, None] * cK2[None, :] * val)
                    for (ii, jj) in ((i, j), (j, i)):
                        for (kk, ll) in ((k, l), (l, k)):
                            eri[ii, jj, kk, ll] = v
                            eri[kk, ll, ii, jj] = v
                    done.add((i, j, k, l))
    return eri


def cross_ovlp(mol1, mol2):
    """Overlap between the AOs of two Mole objects (same geometry or not):
    S12[i, j] = <chi_i^{(1)} | chi_j^{(2)}> (s shells)."""
    S = np.zeros((mol1.nao, mol2.nao))
    for i, (ci, prim_i) in enumerate(mol1.shells):
        ai = np.asarray([p[0] for p in prim_i])
        di = np.asarray([p[1] for p in prim_i])
        for j, (cj, prim_j) in enumerate(mol2.shells):
            aj = np.asarray([p[0] for p in prim_j])
            dj = np.asarray([p[1] for p in prim_j])
            a = ai[:, None]
            b = aj[None, :]
            p = a + b
            AB2 = np.sum((ci - cj) ** 2)
            val = (np.pi / p) ** 1.5 * np.exp(-a * b / p * AB2)
            S[i, j] = np.sum(di[:, None] * dj[None, :] * val)
    return S


def boys0(x):
    """Boys function F0(x) = 0.5 sqrt(pi/x) erf(sqrt(x)), stable at 0."""
    x = np.asarray(x, dtype=float)
    small = x < 1e-12
    xs = np.where(small, 1.0, x)
    out = 0.5 * np.sqrt(np.pi / xs) * erf(np.sqrt(xs))
    return np.where(small, 1.0 - x / 3.0, out)


# ----------------------------------------------------------------------
# geometry helpers
# ----------------------------------------------------------------------

def h_ring(n, r_bond):
    """Ring of n H atoms with nearest-neighbour distance r_bond (bohr):
    the Born-von-Karman form of the H chain (exact cyclic translational
    symmetry, full 1/r Coulomb -- a legitimate periodic model that
    exercises every ab initio DMET component without Ewald sums)."""
    R = r_bond / (2.0 * np.sin(np.pi / n))
    atoms = []
    for i in range(n):
        th = 2.0 * np.pi * i / n
        atoms.append(("H", (R * np.cos(th), R * np.sin(th), 0.0)))
    return atoms


def h_ring_mole(n, r_bond, basis="sto-6g"):
    return Mole(h_ring(n, r_bond), basis=basis)
