"""
The FCI sigma H c on the card: the wrapper, the plan and the Python mirror
of the hand-written Hopper kernel csrc/fci_sigma.cu (FP64 tensor cores).

    g_a   = H_aa D^a + H_ab D^b,      D^s[pq] = E^s_pq c
    g_b   = H_bb D^b + H_ab^T D^a
    sigma = sum_pq E^a_pq g_a[pq] + E^b_pq g_b[pq]

The kernel never writes D^s or g_s: it gathers the non-zero rows of D^s
from c over each string's incoming links, multiplies them by the integral
rows those links select, and adds the products' rows into the sigma rows
of the strings' outgoing links, held in shared memory.  Strings are
walked in batches that share no excitation target (string_batches), so the
adds of one batch never meet and the result does not depend on timing.

FciSigma is the wrapper: CPU tensors take the plain version (solvers/fci
_sigma_uhf / _sigma_rhf), CUDA tensors the kernel, on the plan that
sigma_plan gives for (norb, nelec); it raises on what the kernel does not
take.  sigma_mirror runs the kernel's plan in PyTorch on any device: the
CPU tests hold it to the plain version.
"""

import collections
import ctypes
from functools import lru_cache
from math import comb

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops import _build
from libdmet_preview_tpu_torch.ops.eri_kernels import H100_SMS
from libdmet_preview_tpu_torch.utils import timer

# the kernel's constants (csrc/fci_sigma.cu): 8 warps a block, batches of
# at most JB strings, column tiles of at most CT columns, at most MT_MAX
# m-tiles of 16 rows rs a pass, W slice rows padded by WPAD doubles; the
# shared memory a block may use on an H100.  NORB_MAX: a step's staged
# target rows (16 strings x norb^2 int16 in the cross term) are at most the
# 2 x THREADS 16-byte chunks its threads copy
NORB_MAX = 16
THREADS = 256
JB = 8
CT = 16
MT_MAX = 5
WPAD = 4
SMEM_MAX = 232448
# k-step counts the kernel is built for: a spin's links are padded to the
# smallest that holds both spins' (one block of straight-line MMA code a
# k-step)
NK_CLASSES = (3, 5, 8, 11, 18)
SIDE_WORDS = 30
# stage buffers of link words and target rows: a ring of three
STAGES = 3
# launches a build: the layout copy, the main kernel, the sum of pieces
LAUNCHES = 3


def _cdiv(a, b):
    return -(-a // b)


def _strings(norb, nelec):
    from libdmet_preview_tpu_torch.solvers.fci import make_strings
    return make_strings(norb, nelec)


# ----------------------------------------------------------------------
# host tables
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def string_batches(norb, nelec):
    """Batches of at most JB strings no two of which share an excitation
    target (E_pq |I> and E_rs |J> never the same string: I and J differ by
    three electrons or more).  Returns (perm, bs, nbatch): batch b holds
    the strings perm[bs b : bs (b + 1)], -1 where padded (at a batch's
    end), bs = min(JB, number of strings).

    First fit over the strings ordered by the sums of their occupied
    orbitals and of their squares modulo a prime above norb, which
    separate strings one or two electrons apart (924 strings of 6 in 12
    orbitals in 119 batches, against 151 in ascending order)."""
    from libdmet_preview_tpu_torch.solvers.fci import make_link_table
    strs = _strings(norb, nelec)
    n = len(strs)
    bs = min(JB, n)
    targets = make_link_table(norb, nelec)[:, :, 1]
    occ = [[o for o in range(norb) if (s >> o) & 1] for s in strs.tolist()]
    p = next(q for q in range(norb + 1, 4 * norb + 8)
             if all(q % d for d in range(2, q)))
    key = np.asarray([(sum(o) % p) * p + sum(x * x for x in o) % p
                      for o in occ], dtype=np.int64)
    batches = _first_fit(np.argsort(key, kind="stable"), targets, n, bs)
    perm = np.full((len(batches), bs), -1, dtype=np.int32)
    for b, members in enumerate(batches):
        perm[b, :len(members)] = members
    return perm.reshape(-1), bs, len(batches)


def _first_fit(order, targets, n, bs):
    """Each string, in `order`, into the first batch with room whose
    members' targets miss its own."""
    covered = np.zeros((_cdiv(n, bs) * 2 + 1, n), dtype=bool)
    members = []
    open_ = []                     # batches with room, ascending
    for j in order:
        tj = targets[j]
        fit = None
        if open_:
            ok = ~covered[np.ix_(open_, tj)].any(axis=1)
            if ok.any():
                fit = open_[int(np.argmax(ok))]
        if fit is None:
            fit = len(members)
            members.append([])
            if fit == len(covered):
                covered = np.concatenate([covered, np.zeros_like(covered)])
            open_.append(fit)
        covered[fit, tj] = True
        members[fit].append(int(j))
        if len(members[fit]) == bs:
            open_.remove(fit)
    return members


@lru_cache(maxsize=None)
def row_positions(norb):
    """(pos, nnp): the row rs = r norb + s of the products at position
    pos[rs] of nnp = 16 m-tiles.  E_pp |J> = |J> for every occupied p, so
    the diagonal rows of one string all add into the same sigma row: they
    go to positions 16 (p // 2) + p % 2, the rows that lane g = 0 of the
    MMA holds, which adds them one after the other; the other rows fill
    the remaining positions in order."""
    nn = norb * norb
    nmt = max(_cdiv(nn, 16), _cdiv(norb, 2))
    diag = np.arange(norb) * (norb + 1)
    slots = 16 * (np.arange(norb) // 2) + np.arange(norb) % 2
    pos = np.full(nn, -1, dtype=np.int64)
    pos[diag] = slots
    free = np.setdiff1d(np.arange(16 * nmt), slots)
    pos[pos < 0] = free[:nn - norb]
    return pos, 16 * nmt


@lru_cache(maxsize=None)
def w_rows(norb):
    """(phi, nrow): the integral row pq = a norb + i sits at row phi[pq] of
    the nrow rows of the shared-memory slice.  A k-step's four lanes read
    four rows at once; with rows of 16 mt + 4 doubles, rows in different
    classes phi % 4 fall in different banks.  phi % 4 = (a + i + a // 4)
    % 4, which splits the links into a string about evenly (link_tables
    then deals them over the k-steps class by class)."""
    nn = norb * norb
    a, i = np.divmod(np.arange(nn), norb)
    cls = (a + i + a // 4) % 4
    phi = np.zeros(nn, dtype=np.int64)
    for k in range(4):
        idx = np.flatnonzero(cls == k)
        phi[idx] = 4 * np.arange(len(idx)) + k
    return phi, 4 * int(np.bincount(cls, minlength=4).max())


@lru_cache(maxsize=None)
def link_tables(norb, nelec, nk=None):
    """(words, out, nk) of one spin for the kernel.

    words (nstr, 4 nk) int32: the incoming links of each string J
    (E_pq |I> = sign |J>) in nk k-steps of 4 (at least the links need;
    more pads), each packed as bit 0 valid,
    bit 1 negative sign, bits 2-10 the integral row w_rows()[pq], bits
    11-31 I.  A string's links are sorted by bank class and dealt over its
    k-steps in turn, so the four rows of a k-step rarely share banks;
    padding words (valid 0) name a row of a class the k-step lacks.
    out (nstr, nnp) int16 (row_positions): (K + 1) * sign at position
    pos[rs] where E_rs |J> = sign |K>, else 0."""
    from libdmet_preview_tpu_torch.solvers.fci import (make_incoming_table,
                                                       make_link_table)
    pos, nnp = row_positions(norb)
    nstr = comb(norb, nelec)
    if nelec == 0:
        return (np.zeros((nstr, 0), np.int32), np.zeros((nstr, nnp),
                                                        np.int16), 0)
    phi, _ = w_rows(norb)
    pq, I, sign = make_incoming_table(norb, nelec)
    nlink = pq.shape[1]
    nk = max(nk or 0, _cdiv(nlink, 4))
    row = phi[pq]
    packed = ((I.astype(np.int64) << 11) | (row << 2)
              | ((sign < 0).astype(np.int64) << 1) | 1)
    order = np.argsort(row % 4, axis=1, kind="stable")
    m = np.arange(4 * nk)
    dest = 4 * (m % nk) + m // nk            # k-step m % nk, lane m // nk
    words = np.zeros((nstr, 4 * nk), dtype=np.int64)
    strs = np.arange(nstr)[:, None]
    words[strs, dest[None, :nlink]] = packed[strs, order]
    cls = np.full((nstr, 4 * nk), -1, dtype=np.int64)
    cls[strs, dest[None, :nlink]] = (row % 4)[strs, order]
    for d in dest[nlink:]:
        k0 = 4 * (d // 4)
        present = cls[:, k0:k0 + 4]
        lack = np.argmax(np.stack([(present != c).all(axis=1)
                                   for c in range(4)], axis=1), axis=1)
        words[:, d] = lack << 2
        cls[:, d] = lack
    tab = make_link_table(norb, nelec)
    out = np.zeros((nstr, nnp), dtype=np.int64)
    rows = np.repeat(np.arange(nstr), tab.shape[1])
    out[rows, pos[tab[:, :, 0].ravel()]] = ((tab[:, :, 1].ravel() + 1)
                                            * tab[:, :, 2].ravel())
    return (words.astype(np.uint32).view(np.int32), out.astype(np.int16), nk)


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------

SidePlan = collections.namedtuple(
    "SidePlan",
    "own n_own n_oth npad_own npad_oth bs_own nbatch_own nk_own nk_oth cs "
    "ntc ntile same cross bps blocks")

SigmaPlan = collections.namedtuple(
    "SigmaPlan",
    "norb nelec nn nrow nnp nmt mt npass nsplit nkm stage_bytes "
    "sig_doubles smem sides npieces")


def _side(own, n_own, n_oth, spin_own, spin_oth, width, nkm):
    perm_o, bs_o, nb_o = spin_own["batches"]
    perm_t = spin_oth["batches"][0]
    cs = min(width, len(perm_t))
    active = spin_own["nlink"] > 0
    return dict(own=own, n_own=n_own, n_oth=n_oth, npad_own=len(perm_o),
                npad_oth=len(perm_t), bs_own=bs_o, nbatch_own=nb_o,
                nk_own=nkm, nk_oth=nkm, cs=cs,
                ntc=_cdiv(cs, 8), ntile=_cdiv(len(perm_t), cs), same=active,
                cross=active and spin_oth["nlink"] > 0)


def sigma_plan(norb, nelec, n_sm=H100_SMS, nsplit=None):
    """The kernel's plan for (norb, nelec) on n_sm SMs, from the shape
    only (a SigmaPlan).

    A block of 8 warps owns one side (alpha, then beta), one tile of cs
    columns of the other spin's batch positions (sigma rows of all own
    strings x cs columns in shared memory) and a range of bps of its own
    batches; the norb^2 rows rs run in passes of mt m-tiles of 16 (W slice
    in shared memory), mt the most that fits beside the sigma rows, STAGES
    stage buffers and the tile's columns' link words.  cs is the widest of
    16, 8, 4, 2, 1 (and at most npad_oth) at which one m-tile a pass fits:
    16 at 924 strings a spin (12 orbitals, 6 electrons), 8 at 1,716 (13,
    6), 1 at 12,870 (16, 8), where the MMAs' padded columns run 4.5 times
    sigma_work's count.  Both spins' links are padded to nkm k-steps,
    the smallest of NK_CLASSES that holds them.  nsplit, the pieces the
    own batches are split into, minimizes waves x (batches a block + 2);
    pieces sum in piece order.  Raises ValueError beyond the kernel's
    limits: norb above NORB_MAX, more than 4 NK_CLASSES[-1] links a
    string, 32,767 strings a spin or more, or shared memory at cs = 1
    (none of the last three reached at norb <= 16)."""
    nea, neb = nelec
    if not 0 < norb <= NORB_MAX:
        raise ValueError("fci sigma kernel: norb %d outside 1..%d"
                         % (norb, NORB_MAX))
    if not (0 <= nea <= norb and 0 <= neb <= norb):
        raise ValueError("fci sigma kernel: nelec %s for norb %d"
                         % (nelec, norb))
    nn = norb * norb
    nnp = row_positions(norb)[1]
    nrow = w_rows(norb)[1]
    nmt = nnp // 16
    spins = []
    for ne in (nea, neb):
        nlink = ne * (norb - ne) + ne
        spins.append({"nstr": comb(norb, ne), "nlink": nlink,
                      "nk": _cdiv(nlink, 4),
                      "batches": string_batches(norb, ne)})
    na, nb = spins[0]["nstr"], spins[1]["nstr"]
    if max(na, nb) >= 2 ** 15 - 1:
        raise ValueError("fci sigma kernel: %d strings exceed the int16 "
                         "target table" % max(na, nb))
    nks = [sp["nk"] for sp in spins if sp["nlink"] > 0]
    nkm = next((c for c in NK_CLASSES if c >= max(nks + [0])), None)
    if nkm is None:
        raise ValueError("fci sigma kernel: %d k-steps exceed %d"
                         % (max(nks), NK_CLASSES[-1]))
    for width in (CT, 8, 4, 2, 1):  # both spins' links padded to nkm
        sides = [_side("a", na, nb, spins[0], spins[1], width, nkm),
                 _side("b", nb, na, spins[1], spins[0], width, nkm)]
        act = [sd for sd in sides if sd["same"]]
        stage = max([JB * 16 * nkm + JB * nnp * 2 for sd in act]
                    + [2 * JB * nnp * 2 for sd in act if sd["cross"]] + [0])
        stage = _cdiv(stage, 16) * 16
        sig = _cdiv(max([sd["n_own"] * sd["cs"] for sd in act] + [0]), 2) * 2
        cwords = max([16 * CT * nkm for sd in act if sd["cross"]] + [0])

        def smem(m):
            return (8 * sig + 8 * nrow * (16 * m + WPAD) + STAGES * stage
                    + cwords)
        fits = [m for m in range(1, min(MT_MAX, nmt) + 1)
                if smem(m) <= SMEM_MAX]
        if fits or not act:
            break
    if act and not fits:
        raise ValueError("fci sigma kernel: (norb %d, nelec %s) needs %d B "
                         "of shared memory, more than %d"
                         % (norb, nelec, smem(1), SMEM_MAX))
    mt = max(fits) if fits else 1
    if nsplit is None:
        most = max([sd["nbatch_own"] for sd in act] + [1])
        ntile = sum(sd["ntile"] for sd in act)

        def cost(k):
            return _cdiv(ntile * k, n_sm) * (_cdiv(most, k) + 2)
        nsplit = min(range(1, most + 1), key=lambda k: (cost(k), k))
    out = []
    for sd in sides:
        bps = _cdiv(sd["nbatch_own"], nsplit)
        blocks = sd["ntile"] * nsplit if sd["same"] else 0
        out.append(SidePlan(bps=bps, blocks=blocks, **sd))
    npieces = nsplit * len(act)
    return SigmaPlan(norb, tuple(nelec), nn, nrow, nnp, nmt, mt,
                     _cdiv(nmt, mt), nsplit, nkm, stage, sig,
                     smem(mt) if act else 0, tuple(out), npieces)


def sigma_work(norb, nelec):
    """FLOPs of one build: (counted, run, least).  counted is
    perfbench/roofline.sigma_work's count (a norb^2-row multiply-add for
    every non-zero entry of D^a and D^b with each of the two blocks it
    meets); run is what the kernel's MMAs do on its plan, padding of the
    k-steps, the m-tiles and the column and batch slots included; least is
    what the function needs when each product keeps only the rows rs that
    a string's outgoing links use, 2 ndet (nl_a + nl_b)^2 (1.20e10 against
    4.13e10 counted at 12 orbitals, 6 + 6)."""
    plan = sigma_plan(norb, nelec)
    nn = norb * norb
    na, nb = comb(norb, nelec[0]), comb(norb, nelec[1])
    nl = [ne * (norb - ne) + ne for ne in nelec]
    counted = 4 * nn * na * nb * sum(nl)
    mma = 2 * 16 * 8 * 4
    run = 0
    for s in plan.sides:
        if s.same:
            run += mma * plan.nmt * s.nk_own * s.ntc * s.n_own * s.ntile
        if s.cross:
            steps = sum(_cdiv(max(0, min(s.nbatch_own, b0 + s.bps) - b0), 2)
                        for b0 in range(0, plan.nsplit * s.bps, s.bps))
            run += mma * plan.nmt * s.nk_oth * 2 * steps * s.n_oth
    least = 2 * na * nb * sum(nl) ** 2
    return counted, run, least


# ----------------------------------------------------------------------
# the Python mirror of the kernel
# ----------------------------------------------------------------------

def _decode(words):
    """(valid, sign, integral row, source string) of packed link words."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return (w & 1).astype(bool), np.where(w & 2, -1.0, 1.0), \
        (w >> 2) & 511, w >> 11


def layouts(c, norb, nelec):
    """(A, B): c[:, perm_b] (na x npad_b) and c^T[:, perm_a] (nb x npad_a),
    zero at padded positions: the kernel's layout copy."""
    perm_a = torch.as_tensor(string_batches(norb, nelec[0])[0].astype(
        np.int64), device=c.device)
    perm_b = torch.as_tensor(string_batches(norb, nelec[1])[0].astype(
        np.int64), device=c.device)
    A = c[:, perm_b.clamp(min=0)] * (perm_b >= 0)
    B = c.T[:, perm_a.clamp(min=0)] * (perm_a >= 0)
    return A.contiguous(), B.contiguous()


def sigma_mirror(W, c, norb, nelec, plan=None):
    """The kernel's plan run in PyTorch: sigma for c (na, nb) float64.
    W = (Wsame_a, Wcross_a, Wsame_b, Wcross_b), each (nn, nnp) with
    W[pq, rs] = H[rs, pq] (prepare_w).  Every block's sigma rows, step by
    step (all tiles of a side at once: they own disjoint columns), the
    integral rows of each pass, the packed links and target tables, the
    pieces and their sum in piece order.  Raises if two adds of one step
    meet."""
    plan = plan or sigma_plan(norb, nelec)
    na, nb = c.shape
    dev = c.device
    A, B = layouts(c, norb, nelec)
    ws = torch.zeros((max(plan.npieces, 1), na, nb), dtype=c.dtype,
                     device=dev)
    piece = 0
    for si, s in enumerate(plan.sides):
        if not s.same:
            continue
        own, oth = nelec if s.own == "a" else nelec[::-1]
        X, Y = (A, B) if s.own == "a" else (B, A)
        Ws, Wx = W[2 * si], W[2 * si + 1]
        perm_own = string_batches(norb, own)[0]
        perm_oth = string_batches(norb, oth)[0]
        wo, out_own, _ = link_tables(norb, own, plan.nkm)
        wt = link_tables(norb, oth, plan.nkm)[0]
        for split in range(plan.nsplit):
            b0 = split * s.bps
            b1 = min(s.nbatch_own, b0 + s.bps)
            sig = _mirror_block(plan, s, X, Y, Ws, Wx, perm_own, perm_oth,
                                wo, wt, out_own, b0, b1)
            real = perm_oth >= 0
            cols = torch.as_tensor(perm_oth[real].astype(np.int64),
                                   device=dev)
            part = sig[:, torch.as_tensor(np.flatnonzero(real), device=dev)]
            if s.own == "a":
                ws[piece + split][:, cols] = part
            else:
                ws[piece + split][cols, :] = part.T
        piece += plan.nsplit
    out = ws[0].clone() if plan.npieces else torch.zeros_like(c)
    for p in range(1, plan.npieces):
        out = out + ws[p]
    return out


def _mirror_block(plan, s, X, Y, Ws, Wx, perm_own, perm_oth, wo, wt,
                  out_own, b0, b1):
    """Sigma rows (n_own x npad_oth) of one split of one side, every tile at
    once."""
    dev = X.device
    nn, npad = plan.nn, s.npad_oth
    sig = torch.zeros((s.n_own, npad), dtype=X.dtype, device=dev)
    vo, so, pqo, io = _decode(wo)
    vt, st, pqt, it = _decode(wt)
    col_oth = np.arange(npad)

    def add(K, cols, vals, rows, diag):
        """sig[K, cols] += vals: the adds of other rows never meet; the
        diagonal rows (K the string itself) go one row after the other,
        in row order, as lane g = 0 of the MMA adds them."""
        flat = K * npad + cols
        off = ~diag
        if len(np.unique(flat[off])) != int(off.sum()):
            raise AssertionError("fci sigma mirror: two adds of one step "
                                 "meet")
        groups = [off] + [diag & (rows == r) for r in np.unique(rows[diag])]
        for sel in groups:
            if sel.any():
                idx = torch.as_tensor(np.flatnonzero(sel), device=dev)
                sig.view(-1).index_add_(
                    0, torch.as_tensor(flat[sel], device=dev), vals[idx])

    for phase in ("same", "cross"):
        if not getattr(s, phase):
            continue
        Wg = Ws if phase == "same" else Wx
        per = 1 if phase == "same" else 2
        for p in range(plan.npass):
            r0 = 16 * plan.mt * p
            r1 = min(r0 + 16 * plan.mt, plan.nnp)
            Wp = Wg[:, r0:r1]
            for bb0 in range(b0, b1, per):
                bbs = [bb for bb in range(bb0, bb0 + per) if bb < b1]
                strings = [perm_own[s.bs_own * bb:s.bs_own * (bb + 1)]
                           for bb in bbs]
                if phase == "same":
                    J = strings[0][strings[0] >= 0]
                    val = torch.as_tensor(so[J] * vo[J], device=dev)
                    Bm = X[torch.as_tensor(io[J], device=dev)] \
                        * val[:, :, None]                  # J, l, col
                    Am = Wp[torch.as_tensor(pqo[J], device=dev)]  # J, l, rs
                    G = torch.einsum("jlr,jlc->jrc", Am, Bm)
                    tgt = out_own[J][:, r0:r1].astype(np.int64)  # J, rs
                    j_, r_ = np.nonzero(tgt)
                    t = tgt[j_, r_]
                    K = np.abs(t) - 1
                    sg = torch.as_tensor(np.sign(t).astype(np.float64),
                                         device=dev)
                    for_cols = np.broadcast_to(col_oth, (len(K), npad))
                    add(np.repeat(K, npad), for_cols.ravel(),
                        (G[j_, r_] * sg[:, None]).reshape(-1),
                        np.repeat(r_, npad), np.repeat(K == J[j_], npad))
                else:
                    o = perm_oth
                    real = np.flatnonzero(o >= 0)
                    ob = o[real]
                    val = torch.as_tensor(st[ob] * vt[ob], device=dev)
                    src = torch.as_tensor(it[ob], device=dev)
                    Am = Wp[torch.as_tensor(pqt[ob], device=dev)]  # c, l, rs
                    for bb, js in zip(bbs, strings):
                        pos = np.arange(s.bs_own * bb, s.bs_own * (bb + 1))
                        Bm = Y[src[:, :, None],
                               torch.as_tensor(pos, device=dev)] \
                            * val[:, :, None]              # c, l, slot
                        G = torch.einsum("clr,cls->crs", Am, Bm)
                        slots = np.flatnonzero(js >= 0)
                        tgt = out_own[js[slots]][:, r0:r1].astype(np.int64)
                        s_, r_ = np.nonzero(tgt)           # slot, rs
                        t = tgt[s_, r_]
                        K = np.abs(t) - 1
                        sg = torch.as_tensor(np.sign(t).astype(np.float64),
                                             device=dev)
                        vals = G[:, r_, slots[s_]] * sg[None, :]  # c, n
                        add(np.tile(K, len(real)), np.repeat(real, len(K)),
                            vals.reshape(-1), np.tile(r_, len(real)),
                            np.tile(K == js[slots[s_]], len(real)))
    return sig


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------

def prepare_w(h_aa, h_ab, h_bb, norb):
    """(Wsame_a, Wcross_a, Wsame_b, Wcross_b), each (nrow, nnp) float64
    contiguous, W[phi[pq], pos[rs]] = the block's [rs, pq] (w_rows,
    row_positions) and zero elsewhere: H_aa^T, H_ab^T, H_bb^T, H_ab of the
    absorbed (nn, nn) blocks."""
    nn = norb * norb
    pos, nnp = row_positions(norb)
    phi, nrow = w_rows(norb)

    def pad(m):
        w = torch.zeros((nrow, nnp), dtype=torch.float64, device=m.device)
        w[torch.as_tensor(phi, device=m.device)[:, None],
          torch.as_tensor(pos, device=m.device)[None, :]] = m
        return w
    aa, ab, bb = (h.reshape(nn, nn) for h in (h_aa, h_ab, h_bb))
    return pad(aa.T), pad(ab.T), pad(bb.T), pad(ab)


@lru_cache(maxsize=None)
def _tables_on(norb, nelec, n_sm, device):
    """(plan, {spin: (link words, target rows, batch order)}) of (norb,
    nelec) as tensors on CUDA `device`."""
    plan = sigma_plan(norb, nelec, n_sm=n_sm)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    tabs = {}
    for key, ne in zip("ab", plan.nelec):
        words, out, _ = link_tables(norb, ne, plan.nkm)
        tabs[key] = (dev(words if words.size else np.zeros((1, 4), np.int32)),
                     dev(out), dev(string_batches(norb, ne)[0]))
    return plan, tabs


class FciSigma(object):
    """sigma(c) = H c for absorbed integral blocks (h_aa, h_ab, h_bb) (one
    block three times for restricted integrals) of one (norb, nelec).

    CPU tensors: `plain(c)`, the plain version.  CUDA tensors: the kernel
    on sigma_plan's plan, three launches a build (FciSigma.launches counts
    them), inside the span "fci sigma" of the caller; it raises on a c that
    is not float64, (na, nb), contiguous and on the device of the
    integrals, and at construction for a shape beyond the kernel's limits
    (sigma_plan).  No fallback between the two."""

    launches = 0

    def __init__(self, h_aa, h_ab, h_bb, norb, nelec, device, plain):
        self.norb, self.nelec = norb, tuple(nelec)
        self.device = torch.device(device)
        self.plain = plain
        self.shape = (comb(norb, nelec[0]), comb(norb, nelec[1]))
        self._launch = None
        if self.device.type != "cpu":
            sigma_plan(norb, self.nelec)
            self._blocks = (h_aa, h_ab, h_bb)

    def __call__(self, c):
        if c.device.type == "cpu":
            return self.plain(c)
        if c.dtype != torch.float64:
            raise ValueError("fci sigma kernel: c must be float64, got %s"
                             % c.dtype)
        if tuple(c.shape) != self.shape:
            raise ValueError("fci sigma kernel: c of shape %s, expected %s"
                             % (tuple(c.shape), self.shape))
        if not c.is_contiguous():
            raise ValueError("fci sigma kernel: c must be contiguous")
        if c.device.type != "cuda" or self.device.type != "cuda" or (
                self.device.index is not None
                and c.device.index != self.device.index):
            raise ValueError("fci sigma kernel: c on %s, integrals on %s"
                             % (c.device, self.device))
        if self._launch is None:
            self._launch = self._setup(c.device)
        out = self._launch(c)
        FciSigma.launches += LAUNCHES
        timer.count("fci sigma kernel launches", LAUNCHES)
        return out

    def _setup(self, dev):
        plan, tabs = _tables_on(self.norb, self.nelec,
                                  _build.sm_count(dev), dev)
        W = prepare_w(*self._blocks, self.norb)
        del self._blocks
        na, nb = self.shape
        keep = [W, tabs]

        def side_words(si, s):
            own, oth = ("a", "b") if s.own == "a" else ("b", "a")
            wo, out_o, perm_o = tabs[own]
            wt, _, perm_t = tabs[oth]
            so, sp = (nb, 1) if s.own == "a" else (1, nb)
            vals = [0, 0, W[2 * si].data_ptr(), W[2 * si + 1].data_ptr(),
                    wo.data_ptr(), wt.data_ptr(), out_o.data_ptr(),
                    perm_o.data_ptr(), perm_t.data_ptr(), 0, so, sp,
                    s.n_own, s.npad_own, s.npad_oth, s.bs_own, s.nbatch_own,
                    s.nk_own, s.nk_oth, s.cs, s.ntile, s.bps, s.blocks,
                    int(s.same), int(s.cross)]
            return (ctypes.c_longlong * SIDE_WORDS)(*vals)

        words_a = side_words(0, plan.sides[0])
        words_b = side_words(1, plan.sides[1])
        piece_b = plan.nsplit if plan.sides[0].same else 0
        common = (ctypes.c_longlong * 11)(
            plan.nrow, plan.nnp, plan.nnp, plan.mt, plan.npass,
            plan.stage_bytes, plan.sig_doubles, plan.nkm, plan.smem,
            plan.npieces, piece_b)
        fn = _build.load("fci_sigma", "fci_sigma_f64")
        npad_a, npad_b = plan.sides[0].npad_own, plan.sides[0].npad_oth
        npieces = max(plan.npieces, 1)

        def launch(c):
            out = torch.empty((na, nb), dtype=torch.float64, device=dev)
            ws = torch.empty((npieces, na, nb), dtype=torch.float64,
                             device=dev)
            A = torch.empty((na, npad_b), dtype=torch.float64, device=dev)
            B = torch.empty((nb, npad_a), dtype=torch.float64, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = fn(ctypes.c_void_p(c.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()),
                        ctypes.c_void_p(ws.data_ptr()),
                        ctypes.c_void_p(A.data_ptr()),
                        ctypes.c_void_p(B.data_ptr()),
                        ctypes.c_void_p(ctypes.addressof(words_a)),
                        ctypes.c_void_p(ctypes.addressof(words_b)),
                        ctypes.c_void_p(ctypes.addressof(common)),
                        ctypes.c_void_p(stream))
            if rc != 0:
                raise RuntimeError("fci sigma kernel launch failed: "
                                   "cudaError %d" % rc)
            return out
        launch.keep = keep + [words_a, words_b, common]
        launch.plan = plan
        return launch


def fci_sigma_occupancy(nkm, smem):
    """(resident blocks per SM, threads per block, registers per thread) of
    the main kernel for k-step bound nkm at smem bytes of dynamic shared
    memory, from the card's occupancy query."""
    info = (ctypes.c_int * 3)()
    fn = _build.load("fci_sigma", "fci_sigma_occupancy")
    rc = fn(int(nkm), int(smem), ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError("fci sigma occupancy query failed: cudaError %d"
                           % rc)
    return tuple(info)
