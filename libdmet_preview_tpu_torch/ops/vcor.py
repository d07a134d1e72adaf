"""
Correlation-potential (vcor) parametrizations (PyTorch port of
libdmet_preview_tpu/ops/vcor.py, the Bogoliubov families included).

One Vcor class driven by static index/coefficient tables:

    V[s, i, j] = sum_e coeff[e] * param[pidx[e]]  over entries e with
                 (s, i, j) = (sidx[e], iidx[e], jidx[e])

The tables are host NumPy built once; the fused iteration moves the dense
gradient tensor to its device.
"""

import itertools as it
import numpy as np

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import triu_diag_indices


class Vcor(object):
    """Parametrized local potential: param vector <-> (spin_comp, nao, nao)."""

    def __init__(self, nparam, spin_comp, nao, entries, diag_idx=None,
                 restricted=False, bogoliubov=False, idx_range=None):
        self.nparam = nparam
        self.spin_comp = spin_comp
        self.nao = nao
        self.restricted = restricted
        self.bogoliubov = bogoliubov
        self.idx_range = list(range(nao)) if idx_range is None else list(idx_range)
        self.local = True
        self.is_vcor_kpts = False
        self._diag_idx = diag_idx
        pidx, sidx, iidx, jidx, coeff = entries
        self._pidx = np.asarray(pidx, dtype=np.int32)
        self._sidx = np.asarray(sidx, dtype=np.int32)
        self._iidx = np.asarray(iidx, dtype=np.int32)
        self._jidx = np.asarray(jidx, dtype=np.int32)
        self._coef = np.asarray(coeff, dtype=np.float64)
        self._grad = None
        self.param = np.zeros(nparam)
        self.value = self.evaluate()

    def update(self, param):
        self.param = np.asarray(param, dtype=float).copy()
        self.value = self.evaluate()

    def get(self, i=0, kspace=True):
        if kspace or i == 0:
            return self.value
        return np.zeros_like(self.value)

    def islocal(self):
        return self.local

    is_local = islocal

    def length(self):
        return self.nparam

    def evaluate(self):
        V = np.zeros((self.spin_comp, self.nao, self.nao))
        np.add.at(V, (self._sidx, self._iidx, self._jidx),
                  self._coef * self.param[self._pidx])
        return V

    def gradient(self):
        """Dense dV/dparam, (nparam, spin_comp, nao, nao)."""
        if self._grad is None:
            g = np.zeros((self.nparam, self.spin_comp, self.nao, self.nao))
            np.add.at(g, (self._pidx, self._sidx, self._iidx, self._jidx),
                      self._coef)
            self._grad = g
        return self._grad

    def assign(self, v0):
        """Project a target matrix onto the parametrization."""
        v0 = np.asarray(v0, dtype=float)
        g = self.gradient()
        log.eassert(v0.shape == g.shape[1:],
                    "vcor assign: expected shape %s, got %s",
                    g.shape[1:], v0.shape)
        gnorm = np.einsum("aspq, aspq -> a", g, g)
        param = np.einsum("aspq, spq -> a", g, v0) / gnorm
        self.update(param)
        diff = np.abs(v0 - self.get()).max()
        if diff > 1e-7:
            log.warn("vcor.assign: symmetrization imposed, diff = %.5g", diff)

    def diag_indices(self):
        return self._diag_idx

    def __str__(self):
        return str(self.evaluate())


class _Entries(object):
    """Collects a Vcor's (pidx, sidx, iidx, jidx, coeff) tables."""

    def __init__(self):
        self.cols = [[], [], [], [], []]

    def add(self, p, s, i, j, c):
        for col, x in zip(self.cols, (p, s, i, j, c)):
            col.append(x)

    def add_sym(self, p, s, i, j, c):
        self.add(p, s, i, j, c)
        if i != j:
            self.add(p, s, j, i, c)


class VcorNonLocal(object):
    """Non-local correlation potential: independent local blocks per unit
    cell R within `rcells`.

    Parameters are stacked per-cell parameter vectors; R = 0 is Hermitian,
    R != 0 blocks enter as V(R) on <0|V|R> with V(-R) = V(R)^T imposed, so
    that the lattice operator is Hermitian and V(k) = sum_R e^{-ikR} V(R)
    is Hermitian per k.  -R comes from the lattice's cell-index algebra
    (the JAX package's (-R) % ncells is that cell on a 1D mesh only).

    There is no non-local Bogoliubov vcor: bogoliubov=True fails the same
    assertion as in the JAX package (a pairing potential goes through the
    GSO frame, ops/spinless.py, with a local Bogoliubov vcor)."""

    def __init__(self, restricted, bogoliubov, lattice, rcells=None):
        assert not bogoliubov, "nonlocal Bogoliubov vcor: use the GSO path"
        self.restricted = restricted
        self.bogoliubov = bogoliubov
        self.local = False
        self.is_vcor_kpts = False
        self.lattice = lattice
        self.nao = n = lattice.nscsites
        ncells = lattice.ncells
        if rcells is None:
            rcells = list(range(ncells))
        self.rcells = list(rcells)
        assert 0 in self.rcells
        self.spin = spin = 1 if restricted else 2
        # R = 0: symmetric, n(n+1)/2 params per spin;
        # R != 0: full n^2 per spin (V(-R) tied to V(R)^T)
        self._npair = n * (n + 1) // 2
        self._nfull = n * n
        nparam = 0
        self._offsets = {}
        for R in self.rcells:
            self._offsets[R] = nparam
            nparam += spin * (self._npair if R == 0 else self._nfull)
        self.nparam = nparam
        self.param = np.zeros(nparam)
        self._tri = np.triu_indices(n)
        self._grad = None

    def length(self):
        return self.nparam

    def islocal(self):
        return self.local

    is_local = islocal

    def update(self, param):
        self.param = np.asarray(param, dtype=float).copy()

    def evaluate_R(self):
        """Stripe (spin, ncells, n, n): <0|V|R> blocks, V(-R) = V(R)^T."""
        n = self.nao
        V = np.zeros((self.spin, self.lattice.ncells, n, n))
        for R in self.rcells:
            off = self._offsets[R]
            size = self._npair if R == 0 else self._nfull
            p = self.param[off:off + self.spin * size].reshape(self.spin,
                                                               size)
            if R == 0:
                block = np.zeros((self.spin, n, n))
                block[:, self._tri[0], self._tri[1]] = p
                diag = np.einsum("sii -> si", block)
                V[:, 0] += block + block.transpose(0, 2, 1)
                V[:, 0, np.arange(n), np.arange(n)] -= diag
            else:
                block = p.reshape(self.spin, n, n)
                V[:, R] += block
                V[:, self.lattice._neg_map[R]] += block.transpose(0, 2, 1)
        return V

    def get(self, i=0, kspace=True):
        """k-space pair ((spin, nk, n, n) re, im) if kspace else stripe."""
        VR = self.evaluate_R()
        if not kspace:
            return VR
        from libdmet_preview_tpu_torch.ops import fourier
        return fourier.R2k(VR, tuple(self.lattice.kmesh))

    evaluate = evaluate_R

    def gradient_R(self):
        """(nparam, spin, ncells, n, n) stripe gradient."""
        if self._grad is not None:
            return self._grad
        n = self.nao
        ncells = self.lattice.ncells
        g = np.zeros((self.nparam, self.spin, ncells, n, n))
        for R in self.rcells:
            off = self._offsets[R]
            for s in range(self.spin):
                if R == 0:
                    for k, (i, j) in enumerate(zip(*self._tri)):
                        g[off + s * self._npair + k, s, 0, i, j] += 1.0
                        if i != j:
                            g[off + s * self._npair + k, s, 0, j, i] += 1.0
                else:
                    for k in range(self._nfull):
                        i, j = divmod(k, n)
                        g[off + s * self._nfull + k, s, R, i, j] += 1.0
                        g[off + s * self._nfull + k, s,
                          self.lattice._neg_map[R], j, i] += 1.0
        self._grad = g
        return g

    def assign(self, VR):
        """Project a stripe potential onto the parametrization."""
        g = self.gradient_R().reshape(self.nparam, -1)
        v = np.asarray(VR, dtype=float).ravel()
        gnorm = np.einsum("px, px -> p", g, g)
        self.update(g @ v / gnorm)

    def diag_indices(self):
        return None


def VcorLocal(restricted, bogoliubov, nscsites, idx_range=None, bogo_res=False,
              v_idx=None, ghf=False):
    """Local vcor over idx_range orbitals.

    Parameter layout matches the JAX package (and the reference):
      restricted:    nV = m(m+1)/2 upper-triangle params shared by both spins
      unrestricted:  nV = m(m+1)   first half alpha, second half beta
      bogoliubov:    extra nD pairing params appended
    """
    if idx_range is None:
        idx_range = list(range(nscsites))
    nidx = len(idx_range)
    pairs = list(it.combinations_with_replacement(idx_range, 2))
    npair = len(pairs)

    entries = [[], [], [], [], []]  # pidx, sidx, iidx, jidx, coeff

    def add(p, s, i, j, c):
        entries[0].append(p)
        entries[1].append(s)
        entries[2].append(i)
        entries[3].append(j)
        entries[4].append(c)

    def add_sym(p, s, i, j, c):
        add(p, s, i, j, c)
        if i != j:
            add(p, s, j, i, c)

    if restricted and not bogoliubov:
        if v_idx is not None:
            nV = len(v_idx)
            use_pairs = list(v_idx)
        else:
            nV = npair
            use_pairs = pairs
        nD = 0
        for idx, (i, j) in enumerate(use_pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx, 1, i, j, 1.0)
        if v_idx is not None:
            diag_idx = [np.asarray([k for k, (i, j) in enumerate(v_idx) if i == j])]
        else:
            diag_idx = [triu_diag_indices(nidx)]
        spin_comp = 2
    elif not restricted and not bogoliubov:
        nV = npair * 2
        nD = 0
        for idx, (i, j) in enumerate(pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx + npair, 1, i, j, 1.0)
        d = triu_diag_indices(nidx)
        diag_idx = [d, np.asarray(d) + npair]
        spin_comp = 2
    elif restricted and bogoliubov:
        nV = npair
        nD = npair
        for idx, (i, j) in enumerate(pairs):
            if ghf:
                add_sym(idx, 0, i, j, 1.0)
                add_sym(idx, 1, i, j, -1.0)
            else:
                add_sym(idx, 0, i, j, 1.0)
                add_sym(idx, 1, i, j, 1.0)
            add_sym(idx + nV, 2, i, j, 1.0)
        diag_idx = [triu_diag_indices(nidx)]
        spin_comp = 3
    else:  # unrestricted bogoliubov
        nV = npair * 2
        for idx, (i, j) in enumerate(pairs):
            add_sym(idx, 0, i, j, 1.0)
            add_sym(idx + npair, 1, i, j, 1.0)
        if bogo_res:
            nD = npair
            for idx, (i, j) in enumerate(pairs):
                add_sym(idx + nV, 2, i, j, 1.0)
        else:
            prod = list(it.product(idx_range, repeat=2))
            nD = len(prod)
            for idx, (i, j) in enumerate(prod):
                add(idx + nV, 2, i, j, 1.0)
        d = triu_diag_indices(nidx)
        diag_idx = [d, np.asarray(d) + npair]
        spin_comp = 3

    return Vcor(nV + nD, spin_comp, nscsites, entries, diag_idx=diag_idx,
                restricted=restricted, bogoliubov=bogoliubov,
                idx_range=idx_range)


def VcorRestricted(restricted, bogoliubov, active_sites, core_sites,
                   bogo_res=False, nscsites=None):
    """Full vcor block over active_sites + DIAGONAL-only potential over
    core_sites.

    Parameter layout: the active upper-triangle pairs first (doubled for
    unrestricted: alpha block then beta), then the core diagonals (doubled
    for unrestricted), then, with bogoliubov, the pairing parameters of the
    active block (none on the core sites): its upper triangle (restricted
    or bogo_res) or its full square."""
    active_sites = list(active_sites)
    core_sites = list(core_sites)
    nact, ncor = len(active_sites), len(core_sites)
    if nscsites is None:
        nscsites = nact + ncor
    pairs = list(it.combinations_with_replacement(active_sites, 2))
    npair = len(pairs)
    ent = _Entries()
    d = np.asarray([k for k, (i, j) in enumerate(pairs) if i == j], dtype=int)
    if restricted:
        nV0, nV = npair, npair + ncor
        for idx, (i, j) in enumerate(pairs):
            ent.add_sym(idx, 0, i, j, 1.0)
            ent.add_sym(idx, 1, i, j, 1.0)
        for idx, i in enumerate(core_sites):
            ent.add(nV0 + idx, 0, i, i, 1.0)
            ent.add(nV0 + idx, 1, i, i, 1.0)
        diag_idx = [np.concatenate([d, np.arange(nV0, nV)])]
    else:
        nV0, nV = npair * 2, npair * 2 + ncor * 2
        for idx, (i, j) in enumerate(pairs):
            ent.add_sym(idx, 0, i, j, 1.0)
            ent.add_sym(npair + idx, 1, i, j, 1.0)
        for idx, i in enumerate(core_sites):
            ent.add(nV0 + idx, 0, i, i, 1.0)
            ent.add(nV0 + ncor + idx, 1, i, i, 1.0)
        diag_idx = [np.concatenate([d, np.arange(nV0, nV0 + ncor)]),
                    np.concatenate([d + npair, np.arange(nV0 + ncor, nV)])]
    nD = 0
    if bogoliubov:
        if restricted or bogo_res:
            nD = npair
            for idx, (i, j) in enumerate(pairs):
                ent.add_sym(nV + idx, 2, i, j, 1.0)
        else:
            prod = list(it.product(active_sites, repeat=2))
            nD = len(prod)
            for idx, (i, j) in enumerate(prod):
                ent.add(nV + idx, 2, i, j, 1.0)
    return Vcor(nV + nD, 3 if bogoliubov else 2, nscsites, ent.cols,
                diag_idx=diag_idx, restricted=restricted,
                bogoliubov=bogoliubov,
                idx_range=sorted(active_sites + core_sites))


def VcorKpoints(restricted, bogoliubov, lattice, rcells=None):
    """k-resolved correlation potential, parametrized by real per-cell
    blocks over all cells: the real-R parametrization spans exactly the
    Hermitian translation-invariant k potentials with V(-k) = V(k)*."""
    if rcells is None:
        rcells = list(range(lattice.ncells))
    return VcorNonLocal(restricted, bogoliubov, lattice, rcells=rcells)


def VcorSymm(restricted, bogoliubov, nscsites, perms, spin_swap=None,
             idx_range=None):
    """Point-group symmetric local vcor: one parameter per orbit of
    (spin, i, j) under the given site permutations.

    perms: list of length-nscsites index arrays (site i -> perm[i]);
    spin_swap: optional bools per perm, True where the operation also
    exchanges alpha and beta (AFM-type symmetry).

    bogoliubov=True delegates to VcorSymmBogo (normal orbits + singlet
    pairing orbits)."""
    if bogoliubov:
        return VcorSymmBogo(restricted, nscsites, perms,
                            spin_swap=spin_swap, idx_range=idx_range)
    if idx_range is None:
        idx_range = list(range(nscsites))
    perms = [np.asarray(p, dtype=int) for p in perms]
    if spin_swap is None:
        spin_swap = [False] * len(perms)
    orbits = _normal_orbits(idx_range, perms, spin_swap,
                            1 if restricted else 2)

    ent = _Entries()
    for pidx, orbit in enumerate(orbits):
        for (s, i, j) in orbit:
            for ss in ((0, 1) if restricted else (s,)):
                ent.add_sym(pidx, ss, i, j, 1.0)
    diag = [np.asarray([p for p, orb in enumerate(orbits)
                        if any(i == j for (_, i, j) in orb)])]
    return Vcor(len(orbits), 2, nscsites, ent.cols, diag_idx=diag,
                restricted=restricted, bogoliubov=False,
                idx_range=idx_range)


def _normal_orbits(idx_range, perms, spin_swap, spin):
    """Orbits of the symmetric pairs (s, i, j), i <= j, under the site
    permutations (the spin_swap ones also exchange the spins)."""
    seen = {}
    orbits = []
    for s in range(spin):
        for i in idx_range:
            for j in idx_range:
                if j < i or (s, i, j) in seen:
                    continue
                orbit = set()
                stack = [(s, i, j)]
                while stack:
                    (ss, ii, jj) = stack.pop()
                    kk = (ss, min(ii, jj), max(ii, jj))
                    if kk in orbit:
                        continue
                    orbit.add(kk)
                    for P, sw in zip(perms, spin_swap):
                        s2 = (1 - ss) if (sw and spin == 2) else ss
                        stack.append((s2, int(P[ii]), int(P[jj])))
                for kk in orbit:
                    seen[kk] = len(orbits)
                orbits.append(sorted(orbit))
    return orbits


def _with_diag_shift(v, U):
    """Fold the constant U/2 diagonal shift of both spins into evaluate()."""
    shift = np.zeros((v.spin_comp, v.nao, v.nao))
    shift[:2] += np.eye(v.nao) * (U / 2.0)
    base_eval = v.evaluate
    v.evaluate = lambda: base_eval() + shift
    v.value = v.evaluate()
    return v


def VcorLocalPhSymm(U, bogoliubov, ImpSize, subA, subB, r=None):
    """Particle-hole symmetric vcor for the bipartite half-filled Hubbard
    model: VA_ij + (-)^{i+j} VB_ij = 0, with a fixed U/2 diagonal shift
    folded into evaluate().  bogoliubov=True appends one pairing
    parameter per pair: D_ij = p, D_ji = (-)^{i+j} p."""
    subA, subB = set(subA), set(subB)
    nscsites = int(np.prod(ImpSize))
    log.eassert(subA | subB == set(range(nscsites)),
                "sublattice designation problematic")
    if r is None:
        pairs = list(it.combinations_with_replacement(range(nscsites), 2))
    else:
        sites = list(enumerate(it.product(*map(range, ImpSize))))
        pairs = []
        for (i, ri), (j, rj) in it.combinations_with_replacement(sites, 2):
            if np.linalg.norm(np.asarray(ri) - np.asarray(rj)) < r + 1e-6:
                pairs.append((i, j))

    nV = len(pairs)
    ent = _Entries()
    for idx, (i, j) in enumerate(pairs):
        sign = 1.0 if (i in subA) == (j in subA) else -1.0
        ent.add_sym(idx, 0, i, j, 1.0)
        ent.add_sym(idx, 1, i, j, -sign)
        if bogoliubov:
            ent.add(idx + nV, 2, i, j, 1.0)
            if i != j:
                ent.add(idx + nV, 2, j, i, sign)
    v = Vcor(2 * nV if bogoliubov else nV, 3 if bogoliubov else 2,
             nscsites, ent.cols, restricted=False, bogoliubov=bogoliubov)
    return _with_diag_shift(v, U)


def VcorDCAPhSymm(U, ImpSize, subA, subB):
    """Particle-hole symmetric vcor in the DCA (translation-displacement)
    parametrization: one parameter per displacement class {v, -v} on the
    ImpSize torus, entering as

        V[0, i, i+v] = +p, V[1, i, i+v] = -p   (i, i+v both in subA)
                       -p,                +p   (both in subB)
                       +p,                +p   (mixed)

    for every site i, plus the fixed U/2 diagonal shift."""
    ImpSize = tuple(int(x) for x in np.atleast_1d(ImpSize))
    log.eassert(len(ImpSize) in (1, 2), "ImpSize must be 1D or 2D")
    subA, subB = set(subA), set(subB)
    nscsites = int(np.prod(ImpSize))
    log.eassert(len(subA) == len(subB), "sublattices must have equal size")
    log.eassert(subA | subB == set(range(nscsites)),
                "sublattice designation problematic")

    sites = list(it.product(*map(range, ImpSize)))
    sitedict = dict(zip(sites, range(len(sites))))

    # displacement classes {v, -v} on the torus
    seen = set()
    vectors = []
    for s in sites:
        vec = []
        for s1 in (s, tuple((-np.asarray(s)) % ImpSize)):
            if s1 not in seen:
                vec.append(np.asarray(s1))
                seen.add(s1)
        if vec:
            vectors.append(vec)

    ent = _Entries()
    for idxp, vecs in enumerate(vectors):
        for vec in vecs:
            for idx1, site1 in enumerate(sites):
                idx2 = sitedict[tuple((np.asarray(site1) + vec) % ImpSize)]
                if idx1 in subA and idx2 in subA:
                    ca, cb = 1.0, -1.0
                elif idx1 in subB and idx2 in subB:
                    ca, cb = -1.0, 1.0
                else:
                    ca, cb = 1.0, 1.0
                ent.add(idxp, 0, idx1, idx2, ca)
                ent.add(idxp, 1, idx1, idx2, cb)
    v = Vcor(len(vectors), 2, nscsites, ent.cols, restricted=False,
             bogoliubov=False)
    return _with_diag_shift(v, U)


def VcorSymmBogo(restricted, nscsites, perms, spin_swap=None,
                 idx_range=None):
    """Point-group symmetric Bogoliubov vcor: the normal blocks (va, vb)
    follow VcorSymm's orbits; the pairing block D (symmetric, singlet) gets
    one parameter per orbit of (i, j) pairs under the site permutations.
    spin_swap operations exchange va <-> vb and leave the symmetric D
    invariant."""
    if idx_range is None:
        idx_range = list(range(nscsites))
    perms = [np.asarray(p, dtype=int) for p in perms]
    if spin_swap is None:
        spin_swap = [False] * len(perms)
    orbits = _normal_orbits(idx_range, perms, spin_swap,
                            1 if restricted else 2)
    nV = len(orbits)

    # pairing orbits over unordered (i, j); spin_swap: D -> D^T == D
    seen_d = {}
    orbits_d = []
    for i in idx_range:
        for j in idx_range:
            if j < i or (i, j) in seen_d:
                continue
            orbit = set()
            stack = [(i, j)]
            while stack:
                (ii, jj) = stack.pop()
                kk = (min(ii, jj), max(ii, jj))
                if kk in orbit:
                    continue
                orbit.add(kk)
                for P in perms:
                    stack.append((int(P[ii]), int(P[jj])))
            for kk in orbit:
                seen_d[kk] = len(orbits_d)
            orbits_d.append(sorted(orbit))

    ent = _Entries()
    for pidx, orbit in enumerate(orbits):
        for (s, i, j) in orbit:
            for ss in ((0, 1) if restricted else (s,)):
                ent.add_sym(pidx, ss, i, j, 1.0)
    for pidx, orbit in enumerate(orbits_d):
        for (i, j) in orbit:
            ent.add_sym(nV + pidx, 2, i, j, 1.0)
    diag = [np.asarray([p for p, orb in enumerate(orbits)
                        if any(i == j for (_, i, j) in orb)])]
    return Vcor(nV + len(orbits_d), 3, nscsites, ent.cols, diag_idx=diag,
                restricted=restricted, bogoliubov=True, idx_range=idx_range)
