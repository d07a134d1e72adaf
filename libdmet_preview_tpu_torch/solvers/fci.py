"""
Full CI impurity solver (PyTorch port of libdmet_preview_tpu/solvers/fci.py).

A determinant-string sigma algorithm (Knowles-Handy with the dense
contraction in the middle):

  * string enumeration and single-excitation link tables are built once on
    the host (NumPy, cached per (norb, nelec)) and moved once per device;
  * the sigma vector is
        t1[pq] = E_pq c        (indexed store over the links: no two links
                                share a (pq, target string), so no sum)
        g      = h2e . t1      (one (n^2 x n^2) x (n^2 x na*nb) GEMM)
        sigma  = sum_pq E_pq g (gather over the INCOMING links of each
                                target string and a sum over that fixed
                                axis: every string has exactly nlink
                                incoming links, so the result does not
                                depend on the order atomics would take and
                                two calls agree bit for bit);
  * Davidson keeps its trial vectors and their sigma images on the device;
    the subspace matrix (at most ~30 x 30) is one product, read to the host
    once per iteration for eigh;
  * rdm1/rdm2 are single GEMMs over the same t1 tensors.

Solver contract as in the JAX package: run -> (rdm1, E), run_dmet_ham,
onepdm/twopdm, cleanup.  ghf=True is the generalized-spin-orbital
(spinless) solver of the GSO frame: one fermion species over all norb
orbitals, nelec = (n, 0), so the beta string space holds the single empty
string (no links; the sigma, hdiag and rdm builds take it as it is).
"""

from functools import lru_cache
from math import comb

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils import logger as log
from libdmet_preview_tpu_torch.utils.misc import as_f64
from libdmet_preview_tpu_torch.models.integral import restore_eri


# ----------------------------------------------------------------------
# string tables (host)
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def make_strings(norb, nelec):
    """All nelec-bit strings over norb orbitals, pyscf cistring order
    (ascending binary value)."""
    if nelec == 0:
        return np.asarray([0], dtype=np.int64)
    if nelec > norb:
        raise ValueError("nelec > norb")
    strings = []

    def gen(orb, remaining, current):
        if remaining == 0:
            strings.append(current)
            return
        if orb >= norb:
            return
        # choose orbitals in increasing order -> ascending binary strings
        gen(orb + 1, remaining, current)
        gen(orb + 1, remaining - 1, current | (1 << orb))

    gen(0, nelec, 0)
    return np.asarray(sorted(strings), dtype=np.int64)


def num_strings(norb, nelec):
    return comb(norb, nelec)


@lru_cache(maxsize=None)
def make_link_table(norb, nelec):
    """Link table: for each string I, entries (pq=a*norb+i, J, sign) with
    E_{a i} |I> = sign |J>.  Shape (nstr, nlink, 3), nlink =
    nelec*(norb-nelec+1)."""
    strings = make_strings(norb, nelec)
    addr = {int(s): i for i, s in enumerate(strings)}
    nstr = len(strings)
    nlink = nelec * (norb - nelec) + nelec
    tab = np.zeros((nstr, nlink, 3), dtype=np.int32)
    for I, s in enumerate(strings):
        k = 0
        occ = [o for o in range(norb) if (s >> o) & 1]
        vir = [o for o in range(norb) if not (s >> o) & 1]
        for i in occ:
            # diagonal E_ii
            tab[I, k] = (i * norb + i, I, 1)
            k += 1
        for i in occ:
            for a in vir:
                s1 = (int(s) & ~(1 << i)) | (1 << a)
                # parity: number of occupied orbitals between i and a
                lo, hi = (i, a) if i < a else (a, i)
                nperm = bin(int(s) >> (lo + 1)
                            & ((1 << (hi - lo - 1)) - 1)).count("1")
                sign = 1 - 2 * (nperm & 1)
                tab[I, k] = (a * norb + i, addr[s1], sign)
                k += 1
        assert k == nlink
    return tab


@lru_cache(maxsize=None)
def _flat_links(norb, nelec):
    """Flattened outgoing link arrays (I, pq, J, sign), int32/float64."""
    tab = make_link_table(norb, nelec)
    nstr, nlink, _ = tab.shape
    I = np.repeat(np.arange(nstr, dtype=np.int32), nlink)
    pq = tab[:, :, 0].ravel()
    J = tab[:, :, 1].ravel()
    sign = tab[:, :, 2].ravel().astype(np.float64)
    return I, pq, J, sign


@lru_cache(maxsize=None)
def make_incoming_table(norb, nelec):
    """The link table indexed by its TARGET string: (pq, I, sign), each
    (nstr, nlink), with E_pq |I[J, l]> = sign[J, l] |J>.  E_pq^+ = E_qp maps
    the links out of J one to one onto the links into J, so every string
    has exactly nlink incoming links."""
    I, pq, J, sign = _flat_links(norb, nelec)
    nstr = num_strings(norb, nelec)
    nlink = len(I) // nstr
    if not np.all(np.bincount(J, minlength=nstr) == nlink):
        raise AssertionError("link table: uneven incoming link counts")
    order = np.argsort(J, kind="stable")
    return (pq[order].reshape(nstr, nlink), I[order].reshape(nstr, nlink),
            sign[order].reshape(nstr, nlink))


class _Links(object):
    """One spin's link tables as index tensors on a device: the outgoing
    flat lists (I, pq, J, sign) and the incoming table (pq_in, I_in,
    sign_in)."""

    def __init__(self, norb, nelec, device):
        I, pq, J, sign = _flat_links(norb, nelec)
        pq_in, I_in, sign_in = make_incoming_table(norb, nelec)

        def idx(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long,
                                   device=device)

        self.I, self.pq, self.J = idx(I), idx(pq), idx(J)
        self.sign = as_f64(sign, device)
        self.pq_in, self.I_in = idx(pq_in), idx(I_in)
        self.sign_in = as_f64(sign_in, device)
        self.nstr = num_strings(norb, nelec)


@lru_cache(maxsize=None)
def links_on(norb, nelec, device):
    """Cached link tensors for (norb, nelec) on the torch.device `device`."""
    return _Links(norb, nelec, device)


# ----------------------------------------------------------------------
# link applications and sigma
# ----------------------------------------------------------------------

def _apply_links(ci, links, norb):
    """t1[pq, J, Ib] = sign * ci[I, Ib] over the links (alpha-string
    application).  A (pq, J) pair has one source string, so the indexed
    store has no collisions.

    ci: (na, nb).  Returns (norb*norb, na, nb)."""
    na, nb = ci.shape
    t1 = torch.zeros((norb * norb, na, nb), dtype=ci.dtype, device=ci.device)
    t1[links.pq, links.J] = links.sign[:, None] * ci[links.I]
    return t1


def _apply_links_T(g, links, norb):
    """sigma[J, Ib] = sum_l sign[J, l] * g[pq[J, l], I[J, l], Ib]: the
    second link application as a gather over each target string's incoming
    links and a sum over that axis (deterministic, no atomics)."""
    return torch.sum(links.sign_in[:, :, None] * g[links.pq_in, links.I_in],
                     dim=1)


def _sigma_rhf(h2e, ci, links_a, links_b, norb):
    """H*ci for spin-restricted integrals (same h for both spins)."""
    na, nb = ci.shape
    nn = norb * norb
    t1 = _apply_links(ci, links_a, norb)
    if links_b.I.numel():      # no beta links: the single empty string
        t1 = t1 + _apply_links(ci.T, links_b, norb).transpose(1, 2)
    g = (h2e.reshape(nn, nn) @ t1.reshape(nn, na * nb)).reshape(nn, na, nb)
    sigma = _apply_links_T(g, links_a, norb)
    if links_b.I.numel():
        sigma = sigma + _apply_links_T(g.transpose(1, 2), links_b, norb).T
    return sigma


def _sigma_uhf(h2e_aa, h2e_ab, h2e_bb, ci, links_a, links_b, norb):
    """H*ci with spin-dependent absorbed integrals.

    h2e_ab in chemist (alpha alpha | beta beta)."""
    na, nb = ci.shape
    nn = norb * norb
    t1a = _apply_links(ci, links_a, norb).reshape(nn, -1)
    t1b = _apply_links(ci.T, links_b, norb).transpose(1, 2).reshape(nn, -1)
    g_a = (h2e_aa.reshape(nn, nn) @ t1a
           + h2e_ab.reshape(nn, nn) @ t1b).reshape(nn, na, nb)
    g_b = (h2e_bb.reshape(nn, nn) @ t1b
           + h2e_ab.reshape(nn, nn).T @ t1a).reshape(nn, na, nb)
    sigma = _apply_links_T(g_a, links_a, norb)
    sigma_b = _apply_links_T(g_b.transpose(1, 2), links_b, norb)
    return sigma + sigma_b.T


# ----------------------------------------------------------------------
# integral preparation (absorb one-body into two-body; pyscf convention)
# ----------------------------------------------------------------------

def _absorb(g, f_row, f_col):
    """g[k, k, :, :] += f_row and g[:, :, k, k] += f_col for every k."""
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return g + eye[:, :, None, None] * f_row[None, None] \
        + f_col[:, :, None, None] * eye[None, None]


def absorb_h1e_rhf(h1e, eri, norb, nelec_tot):
    f1e = h1e - torch.einsum("jiik->jk", eri) * 0.5
    f1e = f1e * (1.0 / (nelec_tot + 1e-100))
    return _absorb(eri, f1e, f1e) * 0.5


def absorb_h1e_uhf(h1e, eri, norb, nelec_tot):
    """(h1a, h1b), (g_aa, g_ab, g_bb) -> absorbed (h2e_aa, h2e_ab, h2e_bb);
    mirrors pyscf.fci.direct_uhf.absorb_h1e."""
    h1a, h1b = h1e
    g_aa, g_ab, g_bb = eri
    f1a = h1a - torch.einsum("jiik->jk", g_aa) * 0.5
    f1b = h1b - torch.einsum("jiik->jk", g_bb) * 0.5
    f1a = f1a * (1.0 / (nelec_tot + 1e-100))
    f1b = f1b * (1.0 / (nelec_tot + 1e-100))
    return (_absorb(g_aa, f1a, f1a) * 0.5, _absorb(g_ab, f1b, f1a) * 0.5,
            _absorb(g_bb, f1b, f1b) * 0.5)


@lru_cache(maxsize=None)
def _occ_lists(norb, nelec):
    strs = make_strings(norb, nelec)
    return np.asarray([[o for o in range(norb) if (s >> o) & 1] for s in strs],
                      dtype=np.int64).reshape(len(strs), nelec)


def make_hdiag(h1e, eri, norb, nelec):
    """Diagonal of H over determinants, (na, nb) on the integrals' device.

    h1e: (h1a, h1b); eri: (g_aa, g_ab, g_bb) chemist notation."""
    nea, neb = nelec
    h1a, h1b = h1e
    g_aa, g_ab, g_bb = eri
    dev = h1a.device
    occ_a = torch.as_tensor(_occ_lists(norb, nea), device=dev)
    occ_b = torch.as_tensor(_occ_lists(norb, neb), device=dev)

    def one_spin(h1, g, occ):
        if occ.shape[1] == 0:
            return torch.zeros(occ.shape[0], dtype=h1.dtype, device=dev)
        jd = torch.einsum("iijj->ij", g)
        kd = torch.einsum("ijji->ij", g)
        pair = (jd - kd)[occ[:, :, None], occ[:, None, :]]
        return h1[occ, occ].sum(dim=1) + 0.5 * pair.sum(dim=(1, 2))

    hdiag = one_spin(h1a, g_aa, occ_a)[:, None] \
        + one_spin(h1b, g_bb, occ_b)[None, :]
    if nea and neb:
        jdiag_ab = torch.einsum("iijj->ij", g_ab)
        cross = jdiag_ab[occ_a].sum(dim=1)   # (na, norb): sum_i (ii|pp)
        hdiag = hdiag + cross[:, occ_b].sum(dim=-1)
    return hdiag


# ----------------------------------------------------------------------
# Davidson eigensolver (host decisions over device vectors)
# ----------------------------------------------------------------------

def davidson(matvec, hdiag, x0=None, tol=1e-11, max_cycle=200,
             max_space=30, n_keep=4, guard_cap=8):
    """Lowest eigenpair by Davidson with THICK RESTART and GUARD ROOTS;
    the rules, constants and random numbers of the JAX package's davidson.

    matvec takes and returns a flat tensor on hdiag's device; x0 is a
    tensor there or None.  Returns (theta (float), u (flat tensor)).

    Thick restart: when the subspace is full it collapses onto the lowest
    Ritz vectors (their matvec images are linear combinations of the
    stored ones, so the restart costs no extra sigma builds).

    Guard roots (cold start only): single-root Davidson has a symmetry
    trap -- if the Ritz minimum of the current subspace lies in an
    H-invariant sector (e.g. the spin-swap-antisymmetric triplet
    determinants of an Sz=0 FCI block), every preconditioned residual
    stays in that sector and the iteration converges, with a genuinely
    ZERO residual, to the lowest EXCITED state of that sector.  The rule:
    keep converging Ritz roots UPWARD until some converged root sits
    STRICTLY ABOVE root 0; the higher root's residual expansion probes the
    complementary sector, after which the lowest Ritz pair flips to the
    global ground state.  Cold starts also seed the four lowest-diagonal
    determinants each with dense noise (np.random.RandomState(7)): pure
    determinant seeds that include symmetry-image pairs would give
    sector-pure Ritz vectors.  Warm starts (x0 from a previous solve of a
    nearby Hamiltonian) keep the fast single-root path."""
    hd = hdiag.reshape(-1)
    n = hd.numel()
    dev, dtype = hd.device, hd.dtype
    queue = []
    cold = x0 is None
    rng = np.random.RandomState(7)
    if cold:
        # the seeds follow the host argsort of the diagonal, ties as NumPy
        # breaks them
        order = np.argsort(hd.cpu().numpy())

        def _noisy(k):
            ek = np.zeros(n)
            ek[k] = 1.0
            r = rng.randn(n)
            return as_f64(ek + (0.1 / np.linalg.norm(r)) * r, dev)
        x0 = _noisy(order[0])
        for k in order[1:min(4, n)]:
            queue.append(_noisy(k))
    ctol = max(tol * 10, 1e-9)
    gap_tol = max(tol * 100, 1e-8)
    guard_cap = int(max(2, min(guard_cap, n))) if cold else 1
    # the subspace grows by at most 3 vectors between restart checks
    X = torch.empty((max_space + 3, n), dtype=dtype, device=dev)
    AX = torch.empty_like(X)
    m = 0
    theta, u, rnorm = None, None, np.inf
    e_last = None
    pend = [x0.reshape(-1).to(dtype)]
    n_rand = 0
    for it in range(max_cycle):
        added = 0
        for y in pend:
            # twice-orthogonalize against the subspace (numerical safety)
            for _ in range(2):
                if m:
                    y = y - X[:m].T @ (X[:m] @ y)
            ny = float(torch.linalg.vector_norm(y))
            if ny < 1e-12:
                continue
            y = y / ny
            X[m] = y
            AX[m] = matvec(y).reshape(-1)
            m += 1
            added += 1
        if not added:
            # every candidate collapsed into the span
            if queue:
                pend = [queue.pop(0)]
                continue
            if m >= n or rnorm < ctol or n_rand >= 3:
                break
            n_rand += 1
            pend = [as_f64(rng.randn(n), dev)]
            continue
        Hs = (X[:m] @ AX[:m].T).cpu().numpy()
        Hs = 0.5 * (Hs + Hs.T)
        w, v = np.linalg.eigh(Hs)
        # residuals of the ascending Ritz roots (subspace algebra only, no
        # matvecs), all k at once; the host then walks them up to the
        # first CONVERGED root strictly above root 0
        k = min(guard_cap, m)
        vk = as_f64(v[:, :k].T, dev)                       # (k, m)
        U = vk @ X[:m]
        R = vk @ AX[:m] - as_f64(w[:k], dev)[:, None] * U
        rn_all = torch.linalg.vector_norm(R, dim=1).tolist()
        rnorms = []
        guards_ok = m >= n
        for r in range(k):
            rnorms.append(rn_all[r])
            if r > 0 and rnorms[r] < ctol and w[r] > w[0] + gap_tol:
                guards_ok = True
                break
        if not cold:
            guards_ok = True
        theta, u, rnorm = float(w[0]), U[0], rnorms[0]
        # the residual threshold sets the VECTOR quality: near-degenerate
        # states mix as rnorm/gap, so keep it tight
        conv0 = (e_last is not None and abs(theta - e_last) < tol
                 and rnorm < ctol)
        if conv0 and guards_ok and not queue:
            return theta, u
        e_last = theta
        # expand the (up to 2) lowest unconverged roots among those seen
        pend = []
        for r in range(len(rnorms)):
            if rnorms[r] > ctol:
                denom = hd - float(w[r])
                denom = torch.where(torch.abs(denom) < 1e-10,
                                    torch.full_like(denom, 1e-10), denom)
                pend.append(R[r] / denom)
                if len(pend) >= 2:
                    break
        if queue:
            pend.append(queue.pop(0))
        if m >= max_space:
            # thick restart: keep the lowest Ritz pairs, enough to cover
            # the roots being converged
            keep = min(max(n_keep, len(rnorms) + 1), m)
            vkeep = as_f64(v[:, :keep].T, dev)
            Uk, AUk = vkeep @ X[:m], vkeep @ AX[:m]
            m = 0
            for r in range(keep):
                uk, auk = Uk[r], AUk[r]
                if m:                                  # safety re-orth
                    c = X[:m] @ uk
                    uk = uk - X[:m].T @ c
                    auk = auk - AX[:m].T @ c
                nk_ = float(torch.linalg.vector_norm(uk))
                if nk_ < 1e-10:
                    continue
                X[m] = uk / nk_
                AX[m] = auk / nk_
                m += 1
    if rnorm > ctol:
        log.warn("FCI Davidson not fully converged: resid=%.2e", rnorm)
    return theta, u


# ----------------------------------------------------------------------
# kernel + rdm
# ----------------------------------------------------------------------

def _is_restricted_ints(h1e):
    return (not isinstance(h1e, (tuple, list))) and h1e.ndim == 2


def make_sigma(h1e, eri, norb, nelec, device):
    """(sigma, hdiag) of the FCI Hamiltonian on `device`: sigma maps an
    (na, nb) tensor to H c, hdiag is the (na, nb) diagonal.

    h1e: (n, n) or (h1a, h1b); eri: (n,)*4 or (g_aa, g_ab, g_bb) chemist;
    arrays or tensors."""
    nea, neb = nelec
    links_a = links_on(norb, nea, device)
    links_b = links_on(norb, neb, device)
    if _is_restricted_ints(h1e):
        h1 = as_f64(h1e, device)
        g = as_f64(eri, device)
        h2e = absorb_h1e_rhf(h1, g, norb, nea + neb)
        hdiag = make_hdiag((h1, h1), (g, g, g), norb, nelec)

        def sigma(c):
            return _sigma_rhf(h2e, c, links_a, links_b, norb)
    else:
        h1 = tuple(as_f64(x, device) for x in h1e)
        g = tuple(as_f64(x, device) for x in eri)
        ha, hab, hb = absorb_h1e_uhf(h1, g, norb, nea + neb)
        hdiag = make_hdiag(h1, g, norb, nelec)

        def sigma(c):
            return _sigma_uhf(ha, hab, hb, c, links_a, links_b, norb)
    return sigma, hdiag


def fci_kernel(h1e, eri, norb, nelec, ecore=0.0, tol=1e-11, ci0=None,
               max_cycle=100, device=torch.device("cuda"), counter=None):
    """Solve for the FCI ground state on `device`.

    h1e: (n, n) or (h1a, h1b); eri: (n,)*4 or (g_aa, g_ab, g_bb) chemist.
    counter: optional dict whose "sigma" entry counts the sigma builds.
    Returns (E, ci) with E (float) including ecore and ci an (na, nb)
    tensor."""
    device = torch.device(device)
    nea, neb = nelec
    na, nb = num_strings(norb, nea), num_strings(norb, neb)
    sigma, hdiag = make_sigma(h1e, eri, norb, nelec, device)

    def matvec(x):
        if counter is not None:
            counter["sigma"] = counter.get("sigma", 0) + 1
        return sigma(x.reshape(na, nb)).reshape(-1)

    x0 = None if ci0 is None else as_f64(ci0, device).reshape(-1)
    e, ci = davidson(matvec, hdiag, x0=x0, tol=tol, max_cycle=max_cycle)
    return e + ecore, ci.reshape(na, nb)


def _t1s(ci, norb, nelec):
    links_a = links_on(norb, nelec[0], ci.device)
    links_b = links_on(norb, nelec[1], ci.device)
    t1a = _apply_links(ci, links_a, norb)
    t1b = _apply_links(ci.T, links_b, norb).transpose(1, 2)
    return t1a, t1b


def _trans_rdm1s(ci, norb, nelec):
    """Spin-resolved rdm1: gamma[s][p, q] = <E^s_pq>."""
    t1a, t1b = _t1s(ci, norb, nelec)
    ga = torch.einsum("xab, ab -> x", t1a, ci).reshape(norb, norb)
    gb = torch.einsum("xab, ab -> x", t1b, ci).reshape(norb, norb)
    return ga, gb


def _make_rdm2(ci, norb, nelec):
    """Spin-resolved rdm2 (chemist, reordered):
      G_ss'[p,q,r,s] = <E^s_pq E^s'_rs> - delta_qr delta_ss' <E^s_ps>
    Returns (G_aa, G_bb, G_ab)."""
    nn = norb * norb
    t1a, t1b = _t1s(ci, norb, nelec)
    ga = torch.einsum("xab, ab -> x", t1a, ci).reshape(norb, norb)
    gb = torch.einsum("xab, ab -> x", t1b, ci).reshape(norb, norb)
    t1a = t1a.reshape(nn, -1)
    t1b = t1b.reshape(nn, -1)
    # <c| E_pq = (E_qp c)^T
    perm = torch.arange(nn, device=ci.device).reshape(norb, norb).T.reshape(-1)
    ta_left = t1a[perm]
    tb_left = t1b[perm]
    shape = (norb,) * 4
    Gaa = (ta_left @ t1a.T).reshape(shape)
    Gbb = (tb_left @ t1b.T).reshape(shape)
    Gab = (ta_left @ t1b.T).reshape(shape)
    eye = torch.eye(norb, dtype=ci.dtype, device=ci.device)
    Gaa = Gaa - torch.einsum("qr, ps -> pqrs", eye, ga)
    Gbb = Gbb - torch.einsum("qr, ps -> pqrs", eye, gb)
    return Gaa, Gbb, Gab


def make_rdm1s(ci, norb, nelec):
    ga, gb = _trans_rdm1s(ci, norb, nelec)
    # symmetrize: gamma_pq = <p^+ q>; the transition tensor gives <E_pq>
    return 0.5 * (ga + ga.T), 0.5 * (gb + gb.T)


def make_rdm2s(ci, norb, nelec):
    return _make_rdm2(ci, norb, nelec)


# ----------------------------------------------------------------------
# solver class
# ----------------------------------------------------------------------

def _s1(block, norb, device):
    """One H2 block as an s1 (n,)*4 float64 tensor on `device`."""
    if not (isinstance(block, torch.Tensor) and block.ndim == 4):
        if isinstance(block, torch.Tensor):
            block = block.detach().cpu().numpy()
        block = restore_eri(block, norb, symmetry=1)
    return as_f64(block, device)


class FCI(object):
    """FCI impurity solver: run(ImpHam, nelec=...) -> (rdm1 (spin, n, n)
    tensor on `device`, E).  A later run on a CI space of the same shape
    starts from the stored vector (self.ci).

    n_run counts the run calls and n_sigma the sigma builds since the
    solver was made (or since the caller last set them to 0)."""

    def __init__(self, restricted=False, Sz=0, tol=1e-11, max_cycle=200,
                 ghf=False, device=torch.device("cuda"), **kwargs):
        self.restricted = restricted
        self.Sz = Sz
        self.ghf = ghf
        self.conv_tol = tol
        self.max_cycle = max_cycle
        self.device = torch.device(device)
        self.ci = None
        self.onepdm = None
        self.twopdm = None
        self.norb = None
        self.nelec = None
        self.optimized = False
        self.n_run = 0
        self.n_sigma = 0

    def _ints(self, Ham):
        """(h1e, eri) in fci_kernel's layout from an Integral."""
        norb = Ham.norb
        H1, H2 = Ham.H1["cd"], Ham.H2["ccdd"]
        if Ham.restricted:
            return as_f64(H1[0], self.device), _s1(H2[0], norb, self.device)
        h1 = (as_f64(H1[0], self.device), as_f64(H1[1], self.device))
        # block order [aa, bb, ab] -> (g_aa, g_ab, g_bb)
        return h1, (_s1(H2[0], norb, self.device),
                    _s1(H2[2], norb, self.device),
                    _s1(H2[1], norb, self.device))

    def run(self, Ham, nelec=None, guess=None, calc_rdm2=False, **kwargs):
        norb = Ham.norb
        if nelec is None:
            raise ValueError("FCI.run requires nelec")
        if self.ghf:
            # spinless / generalized-spin-orbital FCI: a single fermion
            # species over all norb orbitals; nelec counts transformed
            # particles
            return self._run_ghf(Ham, nelec, calc_rdm2=calc_rdm2)
        nelec_a = (nelec + self.Sz) // 2
        nelec_b = (nelec - self.Sz) // 2
        assert nelec_a >= 0 and nelec_b >= 0 and nelec_a + nelec_b == nelec
        self.nelec = (nelec_a, nelec_b)
        self.norb = norb

        h1e, eri = self._ints(Ham)
        shape = (num_strings(norb, nelec_a), num_strings(norb, nelec_b))
        ci0 = self.ci if (self.ci is not None
                          and tuple(self.ci.shape) == shape) else None
        counter = {"sigma": 0}
        E, self.ci = fci_kernel(h1e, eri, norb, self.nelec,
                                ecore=float(Ham.H0), tol=self.conv_tol,
                                ci0=ci0, max_cycle=self.max_cycle,
                                device=self.device, counter=counter)
        self.n_run += 1
        self.n_sigma += counter["sigma"]
        ga, gb = make_rdm1s(self.ci, norb, self.nelec)
        if Ham.restricted:
            # spin dimension 1, half of the total rdm
            self.onepdm = (0.5 * (ga + gb))[None]
        else:
            self.onepdm = torch.stack([ga, gb])
        if calc_rdm2:
            self.make_rdm2(Ham)
        self.E = E
        self.optimized = True
        return self.onepdm, E

    def _run_ghf(self, Ham, nelec, calc_rdm2=False):
        norb = Ham.norb
        self.nelec = (nelec, 0)
        self.norb = norb
        h1 = as_f64(Ham.H1["cd"][0], self.device)
        h2 = _s1(Ham.H2["ccdd"][0], norb, self.device)
        shape = (num_strings(norb, nelec), 1)
        ci0 = self.ci if (self.ci is not None
                          and tuple(self.ci.shape) == shape) else None
        counter = {"sigma": 0}
        E, self.ci = fci_kernel(h1, h2, norb, self.nelec,
                                ecore=float(Ham.H0), tol=self.conv_tol,
                                ci0=ci0, max_cycle=self.max_cycle,
                                device=self.device, counter=counter)
        self.n_run += 1
        self.n_sigma += counter["sigma"]
        ga, _ = make_rdm1s(self.ci, norb, self.nelec)
        self.onepdm = ga[None]
        if calc_rdm2:
            self.make_rdm2(Ham)
        self.E = E
        self.optimized = True
        return self.onepdm, E

    def make_rdm2(self, Ham):
        Gaa, Gbb, Gab = make_rdm2s(self.ci, self.norb, self.nelec)
        if self.ghf:
            self.twopdm = Gaa[None]
        elif Ham.restricted:
            self.twopdm = (Gaa + Gbb + Gab + Gab.permute(2, 3, 0, 1))[None]
        else:
            self.twopdm = torch.stack([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, last_aabb=True, **kwargs):
        """Energy of the scaled DMET Hamiltonian with the stored
        rdm1/rdm2."""
        self.make_rdm2(Ham)
        r1, r2 = self.onepdm, self.twopdm
        norb = Ham.norb
        H1 = as_f64(Ham.H1["cd"], self.device)
        H2 = Ham.H2["ccdd"]
        if self.ghf:
            h2 = _s1(H2[0], norb, self.device)
            E1 = torch.sum(H1[0] * r1[0].T)
            E2 = torch.sum(h2 * r2[0]) * 0.5
        elif Ham.restricted:
            h2 = _s1(H2[0], norb, self.device)
            E1 = torch.sum(H1[0] * r1[0].T) * 2.0
            E2 = torch.sum(h2 * r2[0]) * 0.5
        else:
            h2 = [_s1(H2[i], norb, self.device) for i in range(3)]
            # h2 order [aa, bb, ab]; r2 = (Gaa, Gbb, Gab)
            E1 = torch.sum(H1 * r1.transpose(1, 2))
            E2 = (0.5 * torch.sum(h2[0] * r2[0])
                  + 0.5 * torch.sum(h2[1] * r2[1])
                  + torch.sum(h2[2] * r2[2]))
        return float(E1 + E2) + float(Ham.H0)

    def cleanup(self):
        pass
