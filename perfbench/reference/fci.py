"""
Plain full CI for an embedding problem with spin-dependent integrals, in
PyTorch at a chosen dtype (float64 for the reference, float32 for the
control).  Written from the second-quantized Hamiltonian

    H = sum_s sum_pq h'^s_pq E^s_pq + 1/2 sum_ss' sum_pqrs (pq|rs)_ss' E^s_pq E^s'_rs,
    h'^s_ps = h^s_ps - 1/2 sum_q (pq|qs)_ss

with E^s_pq = a+_ps a_qs and chemists' integrals, over determinants
|I_alpha> |I_beta> of occupation bitmasks.  Nothing here comes from the
program: the strings, the excitation tables, the sigma vector, the
diagonal and the eigensolver are built below.
"""

import itertools

import numpy as np
import torch


def strings(norb, nelec):
    """Occupation bitmasks of nelec electrons in norb orbitals, ascending."""
    return np.array(sorted(sum(1 << o for o in occ) for occ in
                           itertools.combinations(range(norb), nelec)),
                    dtype=np.int64)


def _popcount(x):
    x = x.copy()
    n = np.zeros_like(x)
    while np.any(x):
        n += x & 1
        x >>= 1
    return n


def excitation_table(norb, nelec):
    """(src, sign), each (nstr, norb * norb): for E_pq = a+_p a_q and a
    coefficient vector c over the strings,
        (E_pq c)[J] = sign[J, pq] * c[src[J, pq]],
    where src[J, pq] is the string a+_q a_p |J> (index nstr where it
    vanishes, sign 0 there)."""
    strs = strings(norb, nelec)
    nstr = len(strs)
    where = {int(s): i for i, s in enumerate(strs)}
    src = np.full((nstr, norb * norb), nstr, dtype=np.int64)
    sign = np.zeros((nstr, norb * norb))
    for p in range(norb):
        for q in range(norb):
            # a_p |J>, then a+_q
            has_p = (strs >> p) & 1 == 1
            k = strs ^ (1 << p)
            s1 = 1 - 2 * (_popcount(strs & ((1 << p) - 1)) & 1)
            ok = has_p & ((k >> q) & 1 == 0)
            s2 = 1 - 2 * (_popcount(k & ((1 << q) - 1)) & 1)
            res = k | (1 << q)
            for J in np.nonzero(ok)[0]:
                src[J, p * norb + q] = where[int(res[J])]
                sign[J, p * norb + q] = s1[J] * s2[J]
    return src, sign


def occupations(norb, nelec):
    strs = strings(norb, nelec)
    return np.array([[(s >> o) & 1 for o in range(norb)] for s in strs],
                    dtype=np.float64)


class Space(object):
    """The determinant space of (norb, (na, nb)) on a device: per spin the
    excitation tables cut to their non-zero entries (every string has
    the same number of them), and the occupation matrices."""

    def __init__(self, norb, nelec, device, dtype=torch.float64):
        self.norb, self.nelec = norb, tuple(nelec)
        self.device, self.dtype = torch.device(device), dtype
        self.pq, self.src, self.sign, self.occ, self.cols = [], [], [], [], []
        for n in self.nelec:
            src, sign = excitation_table(norb, n)
            nstr = src.shape[0]
            pq = np.stack([np.nonzero(row < nstr)[0] for row in src])
            rows = np.arange(nstr)[:, None]

            def dev(a, dt=None):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       device=self.device, dtype=dt)
            self.pq.append(dev(pq))
            self.src.append(dev(src[rows, pq]))
            self.sign.append(dev(sign[rows, pq], dtype))
            self.occ.append(dev(occupations(norb, n), dtype))
            self.cols.append(dev(np.repeat(np.arange(nstr), pq.shape[1])))
        self.shape = tuple(o.shape[0] for o in self.occ)


def _first_a(c, sp):
    """t[pq, J, b] = (E^a_pq c)[J, b]: each (pq, J) has one source."""
    na, nb = sp.shape
    t = c.new_zeros((sp.norb ** 2, na, nb))
    t[sp.pq[0].reshape(-1), sp.cols[0]] = \
        (sp.sign[0][:, :, None] * c[sp.src[0]]).reshape(-1, nb)
    return t


def _first_b(c, sp):
    """t[pq, a, J] = (E^b_pq c)[a, J]."""
    na, nb = sp.shape
    t = c.new_zeros((sp.norb ** 2, na, nb))
    t[sp.pq[1].reshape(-1), :, sp.cols[1]] = \
        (sp.sign[1][:, :, None] * c.T[sp.src[1]]).reshape(-1, na)
    return t


def _second_a(W, sp):
    """s[J, b] = sum_pq (E^a_pq W[pq])[J, b] for W (nn, na, nb)."""
    return (sp.sign[0][:, :, None] * W[sp.pq[0], sp.src[0]]).sum(1)


def _second_b(W, sp):
    """s[a, J] = sum_pq (E^b_pq W[pq])[a, J] for W (nn, na, nb)."""
    return (sp.sign[1][:, :, None] * W[sp.pq[1], :, sp.src[1]]).sum(1).T


class Hamiltonian(object):
    """H in the determinant space: h = (h_a, h_b) (n, n); g = (g_aa, g_bb,
    g_ab) (n, n, n, n) chemists' notation; ecore a constant."""

    def __init__(self, space, h, g, ecore=0.0):
        dt, dev = space.dtype, space.device
        n = space.norb
        self.space, self.ecore = space, float(ecore)
        h = [torch.as_tensor(x, device=dev).to(dt) for x in h]
        g = [torch.as_tensor(x, device=dev).to(dt) for x in g]
        self.h, self.g = h, g
        nn = n * n
        self.hp = [h[s] - 0.5 * torch.einsum("pqqs->ps", g[s])
                   for s in range(2)]
        self.gaa = g[0].reshape(nn, nn)
        self.gbb = g[1].reshape(nn, nn)
        self.gab = g[2].reshape(nn, nn)

    def diagonal(self):
        sp = self.space
        oa, ob = sp.occ
        ha, hb = self.h
        gaa, gbb, gab = self.g
        J = [torch.einsum("iijj->ij", x) for x in (gaa, gbb, gab)]
        K = [torch.einsum("ijji->ij", x) for x in (gaa, gbb)]

        def one(o, h, J, K):
            return (o @ torch.diagonal(h) + 0.5 * ((o @ J) * o).sum(1)
                    - 0.5 * ((o @ K) * o).sum(1))
        return (one(oa, ha, J[0], K[0])[:, None]
                + one(ob, hb, J[1], K[1])[None, :] + oa @ J[2] @ ob.T)

    def sigma(self, c):
        """H c for c (na, nb), without ecore."""
        sp = self.space
        na, nb = sp.shape
        nn = sp.norb ** 2
        tA = _first_a(c, sp).reshape(nn, -1)
        tB = _first_b(c, sp).reshape(nn, -1)
        flat = c.reshape(1, -1)
        WA = 0.5 * (self.gaa @ tA) + self.gab @ tB \
            + self.hp[0].reshape(nn, 1) * flat
        WB = 0.5 * (self.gbb @ tB) + self.hp[1].reshape(nn, 1) * flat
        return _second_a(WA.reshape(nn, na, nb), sp) \
            + _second_b(WB.reshape(nn, na, nb), sp)

    def rdm1(self, c):
        """(gamma_a, gamma_b), gamma_s[p, q] = <c| E^s_pq |c> (symmetric
        part), for a normalized c."""
        sp = self.space
        n = sp.norb
        ga = _first_a(c, sp).reshape(n * n, -1) @ c.reshape(-1)
        gb = _first_b(c, sp).reshape(n * n, -1) @ c.reshape(-1)
        ga, gb = ga.reshape(n, n), gb.reshape(n, n)
        return 0.5 * (ga + ga.T), 0.5 * (gb + gb.T)


def tolerances(dtype):
    """(energy, residual) at which the solver stops for a dtype."""
    if dtype == torch.float64:
        return 1e-12, 1e-9
    return 1e-6, 1e-3


def davidson(H, nroots=3, max_iter=200, max_space=40, seed=0,
             guard_tol=1e-3):
    """Lowest eigenpair of H by block Davidson: the nroots lowest Ritz
    pairs are expanded, the higher ones until their residual is under
    guard_tol (so a start confined to one symmetry sector cannot hold the
    iteration there); root 0 alone decides convergence.  Starts from the
    nroots lowest diagonal determinants, each with seeded noise.  Returns
    (E including ecore, c (na, nb) normalized)."""
    sp = H.space
    dt, dev = sp.dtype, sp.device
    hd = H.diagonal().reshape(-1)
    n = hd.numel()
    e_tol, r_tol = tolerances(dt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    order = torch.argsort(hd)[:nroots]
    X = torch.empty((max_space + nroots, n), dtype=dt, device=dev)
    AX = torch.empty_like(X)
    m = 0
    new = []
    for k in order.tolist():
        v = 1e-2 * torch.randn(n, generator=gen, dtype=dt, device=dev) \
            / np.sqrt(n)
        v[k] += 1.0
        new.append(v)
    e_old = None
    for _ in range(max_iter):
        for v in new:
            for _ in range(2):
                if m:
                    v = v - X[:m].T @ (X[:m] @ v)
            nv = torch.linalg.vector_norm(v)
            if float(nv) < 1e-8:
                continue
            X[m] = v / nv
            AX[m] = H.sigma(X[m].reshape(sp.shape)).reshape(-1)
            m += 1
        S = X[:m] @ AX[:m].T
        w, V = torch.linalg.eigh(0.5 * (S + S.T))
        k = min(nroots, m)
        U = V[:, :k].T @ X[:m]
        R = V[:, :k].T @ AX[:m] - w[:k, None] * U
        rn = torch.linalg.vector_norm(R, dim=1)
        e0 = float(w[0])
        if (e_old is not None and abs(e0 - e_old) < e_tol
                and float(rn[0]) < r_tol):
            break
        e_old = e0
        new = []
        for r in range(k):
            if float(rn[r]) > (r_tol if r == 0 else max(r_tol, guard_tol)):
                d = hd - w[r]
                d = torch.where(d.abs() < 1e-8, torch.full_like(d, 1e-8), d)
                new.append(R[r] / d)
        if m + len(new) > max_space:
            keep = min(nroots + 3, m)
            Uk = V[:, :keep].T @ X[:m]
            AUk = V[:, :keep].T @ AX[:m]
            X[:keep], AX[:keep] = Uk, AUk
            m = keep
    c = U[0] / torch.linalg.vector_norm(U[0])
    return e0 + H.ecore, c.reshape(sp.shape)
