"""
GTH (Goedecker-Teter-Hutter) pseudopotentials, native implementation
(PyTorch port of libdmet_preview_tpu/ints/gth.py, kept as host NumPy: its
blocks are one-time inputs of the periodic engine, ints/pbc.py).

The reference gets pseudopotential matrix elements from PySCF's pbc.gto
machinery (SURVEY 2.8 item 1; e.g. the GTH-PADE diamond/cuprate/NiO
workloads in the reference libdmet's examples).  This module owns the
capability for general GTH/HGH sets: up to four local C coefficients and
nonlocal projectors for l <= 2 (s/p/d channels) with full h^l_ij
matrices -- enough for first-row elements, Si, alkali C3/C4 sets, and 3d
transition metals (NiO-type AFM oxides).

The GTH form (HGH, PRB 58, 3641 (1998)):
  V_loc(r)  = -Z_ion erf(r / (sqrt(2) r_loc)) / r
              + exp(-r^2/(2 r_loc^2)) [C1 + C2 x^2 + C3 x^4 + C4 x^6],
              x = r/r_loc
  V_nl      = sum_A sum_lm sum_ij |p_i^lm> h^l_ij <p_j^lm|,
              p_i^lm(r) = N_il r^{l+2(i-1)} e^{-r^2/(2 r_l^2)} Y_lm(r^)
              N_il = sqrt(2) / (r_l^{l+2i-1/2} sqrt(Gamma(l+2i-1/2)))

Matrix-element strategy (works molecular AND periodic):
  * the erf/r long-range part equals a point charge -Z_ion beyond a few
    r_loc, so periodic assembly uses the existing point-charge Ewald
    machinery PLUS the SHORT-RANGED difference
    +Z_ion erfc(r/(sqrt(2) r_loc))/r (ints.md.nuc_block screen='erfc');
  * the Gaussian polynomial terms C_k x^{2(k-1)} are EXACT
    polynomial-kernel Hermite integrals (md.R_table kernel='gauss'
    poly=..., md.gauss_pow_block): the r^{2k}-weighted Gaussian kernel
    convolved with a Hermite Gaussian is e^{-x} Q_k(x) in closed form;
  * projectors p_i^lm expand EXACTLY into Cartesian monomials of degree
    l + 2(i-1) (solid harmonic x (x^2+y^2+z^2)^{i-1}), so <AO|p> is a
    plain overlap block against a unit-coefficient shell (md.raw_shell).
    All pieces validated against brute-force quadrature (tests/test_gth).

Parameter provenance: the GTH-PADE (LDA) values below are the published
constants of the GTH/HGH papers as distributed by CP2K/PySCF.  H, C, N,
O, Si are high-confidence transcriptions; Li and Ni are best-effort
transcriptions from the same public tables (no data files ship with the
repository) -- the implementation is quadrature-validated
independently of the parameter values; re-verify Li/Ni digits against
the CP2K POTENTIAL file before production use.
"""

import numpy as np
from scipy.special import gamma as _gamma_fn

from libdmet_preview_tpu_torch.ints.md import (
    CART, ncart, R_table, _pair_E3, ovlp_block, nuc_block, _shifted,
    raw_shell, gauss_pow_block)


def _h_full(l, hdiag):
    """Full h^l matrix from its diagonal using the HGH fixed off-diagonal
    relations (HGH PRB 58, 3641 (1998)); the GTH-PADE data tables list
    only diagonals, with off-diagonals implied by these relations
    (verified: Si s-channel h12 = -1/2 sqrt(3/5) h22 = -1.26189397)."""
    hdiag = np.atleast_1d(np.asarray(hdiag, dtype=float))
    n = hdiag.size
    h = np.diag(hdiag)
    if n >= 2:
        f12 = {0: -0.5 * np.sqrt(3.0 / 5.0),
               1: -0.5 * np.sqrt(5.0 / 7.0),
               2: -0.5 * np.sqrt(7.0 / 9.0)}[l]
        h[0, 1] = h[1, 0] = f12 * h[1, 1]
    if n >= 3:
        f13 = {0: 0.5 * np.sqrt(5.0 / 21.0),
               1: np.sqrt(35.0 / 11.0) / 6.0,
               2: 0.5 * np.sqrt(63.0 / 143.0)}[l]
        f23 = {0: -0.5 * np.sqrt(100.0 / 63.0),
               1: -14.0 / (6.0 * np.sqrt(11.0)),
               2: -9.0 / np.sqrt(143.0)}[l]
        h[0, 2] = h[2, 0] = f13 * h[2, 2]
        h[1, 2] = h[2, 1] = f23 * h[2, 2]
    return h


# {symbol: dict(zion, rloc, cloc=[C1..C4], nl=[(l, r_l, h_matrix), ...])}
# Standard public GTH-PADE (LDA) parameters; see provenance note above.
GTH_PADE = {
    "H": {"zion": 1.0, "rloc": 0.20000000,
          "cloc": [-4.18023680, 0.72507482], "nl": []},
    "Li": {"zion": 3.0, "rloc": 0.40000000,     # q3 all-electron-like set
           "cloc": [-14.03486800, 9.55347600, -1.76648800, 0.08394600],
           "nl": []},
    "C": {"zion": 4.0, "rloc": 0.34883045,
          "cloc": [-8.51377110, 1.22843203],
          "nl": [(0, 0.30455321, _h_full(0, [9.52284179]))]},
    "N": {"zion": 5.0, "rloc": 0.28917923,
          "cloc": [-12.23481988, 1.76640728],
          "nl": [(0, 0.25660487, _h_full(0, [13.55224272]))]},
    "O": {"zion": 6.0, "rloc": 0.24762086,
          "cloc": [-16.58031797, 2.39570092],
          "nl": [(0, 0.22178614, _h_full(0, [18.26691718]))]},
    "Si": {"zion": 4.0, "rloc": 0.44000000,
           "cloc": [-7.33610297],
           "nl": [(0, 0.42273813, _h_full(0, [5.90692831, 3.25819622])),
                  (1, 0.48427842, _h_full(1, [2.72701346]))]},
    # 3d transition metal (18-valence-electron set): unlocks NiO-type
    # AFM oxide workloads.  Best-effort transcription -- see module doc.
    "Ni": {"zion": 18.0, "rloc": 0.35000000,
           "cloc": [3.61031072, 0.44963832],
           "nl": [(0, 0.24510489, _h_full(0, [12.16113071, 2.20784886])),
                  (1, 0.23474009, _h_full(1, [1.15869899])),
                  (2, 0.21494950, _h_full(2, [-13.39506212]))]},
    # Cu q11 (3d10 4s1 valence, semicore in the core): the cuprate
    # element.  Best-effort transcription like Ni -- no local C terms,
    # two s / two p projectors (explicit h12, the PADE fit does not
    # follow the HGH fixed off-diagonal relations here) + one d;
    # re-verify digits against CP2K POTENTIAL before production use.
    "Cu": {"zion": 11.0, "rloc": 0.53000000,
           "cloc": [],
           "nl": [(0, 0.42373410,
                   np.asarray([[9.69205055, -6.46660500],
                               [-6.46660500, 8.35050600]])),
                  (1, 0.57217694,
                   np.asarray([[2.53655610, -0.77900332],
                               [-0.77900332, 0.92170620]])),
                  (2, 0.26614300, _h_full(2, [-12.82861204]))]},
}


# real solid harmonics S_lm = r^l Y_lm as Cartesian monomial expansions:
# {l: [per-m list of [((a,b,c), coef), ...]]}; Y_lm normalized on the
# sphere (int |Y|^2 dOmega = 1)
_C0 = 0.28209479177387814          # 1/sqrt(4 pi)
_C1 = 0.4886025119029199           # sqrt(3/(4 pi))
_C2T = 1.0925484305920792          # sqrt(15/(4 pi))
_C2Z = 0.31539156525252005         # sqrt(5/(16 pi))
_C2E = 0.5462742152960396          # sqrt(15/(16 pi))
SOLID_HARM = {
    0: [[((0, 0, 0), _C0)]],
    1: [[((1, 0, 0), _C1)], [((0, 1, 0), _C1)], [((0, 0, 1), _C1)]],
    2: [
        [((1, 1, 0), _C2T)],                                   # xy
        [((0, 1, 1), _C2T)],                                   # yz
        [((0, 0, 2), 2 * _C2Z), ((2, 0, 0), -_C2Z),
         ((0, 2, 0), -_C2Z)],                                  # 3z^2-r^2
        [((1, 0, 1), _C2T)],                                   # xz
        [((2, 0, 0), _C2E), ((0, 2, 0), -_C2E)],               # x^2-y^2
    ],
}


def _mul_r2(terms):
    """Multiply a {monomial: coef} dict by (x^2 + y^2 + z^2)."""
    out = {}
    for (a, b, c), w in terms.items():
        for d in ((a + 2, b, c), (a, b + 2, c), (a, b, c + 2)):
            out[d] = out.get(d, 0.0) + w
    return out


def projector_cart(l, i, rl):
    """Cartesian expansion of the radial-i, channel-l GTH projector:
    returns (L, alpha, W) with W[m, mono] such that
    p_i^lm(r) = sum_mono W[m, mono] x^a y^b z^c e^{-alpha r^2}
    over CART[L], L = l + 2(i-1), alpha = 1/(2 rl^2)."""
    alpha = 1.0 / (2.0 * rl * rl)
    L = l + 2 * (i - 1)
    nrm = np.sqrt(2.0) / (rl ** (l + 2 * i - 0.5)
                          * np.sqrt(_gamma_fn(l + 2 * i - 0.5)))
    W = np.zeros((2 * l + 1, ncart(L)))
    index = {mono: k for k, mono in enumerate(CART[L])}
    for m, terms0 in enumerate(SOLID_HARM[l]):
        terms = {mono: w for mono, w in terms0}
        for _ in range(i - 1):
            terms = _mul_r2(terms)
        for mono, w in terms.items():
            W[m, index[mono]] = nrm * w
    return L, alpha, W


def gth_channels(pp, center):
    """Per l-channel projector data for one atom: yields
    (h_matrix (np x np), [(L, alpha, W), ...] one per radial index i,
    raw shells at `center`)."""
    out = []
    for l, rl, h in pp.get("nl", []):
        h = np.atleast_2d(np.asarray(h, dtype=float))
        comps = []
        for i in range(1, h.shape[0] + 1):
            L, alpha, W = projector_cart(l, i, rl)
            comps.append((raw_shell(center, L, alpha), W))
        out.append((h, l, comps))
    return out


def gauss_block(sh1, sh2, beta, C, shift=None):
    """sum_A (a| e^{-beta |r - C_A|^2} |b) for one shell pair, BATCHED
    over the centers C (one or many); beta may be complex (complex-step
    derivatives w.r.t. beta)."""
    C = np.atleast_2d(np.asarray(C, dtype=float))
    cplx = np.iscomplexobj(np.asarray(beta))
    out = np.zeros((sh1.nc, sh2.nc), dtype=complex if cplx else float)
    lsum = sh1.l + sh2.l
    for p, c12, P, (Ex, Ey, Ez) in _pair_E3(sh1, sh2, shift):
        gam = p * beta / (p + beta)
        pref = c12 * (np.pi / (p + beta)) ** 1.5
        R = R_table(lsum, lsum, lsum, gam, P[None, :] - C,
                    kernel="gauss")                     # [t,u,v,nC]
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                val = 0.0
                for t in range(l1 + l2 + 1):
                    ex = Ex[l1, l2, t]
                    if ex == 0.0:
                        continue
                    for u in range(m1 + m2 + 1):
                        ey = Ey[m1, m2, u]
                        if ey == 0.0:
                            continue
                        for v in range(n1 + n2 + 1):
                            ez = Ez[n1, n2, v]
                            if ez == 0.0:
                                continue
                            val = val + ex * ey * ez * np.sum(R[t, u, v])
                out[i, j] += pref * val
    return out


def gth_loc_sr_block(sh1, sh2, pp, C, shift=None):
    """SHORT-RANGED local-PP remainder for one atom species at centers C
    (one or many, BATCHED -- e.g. all lattice images of one atom):
    +Z_ion erfc(r_C/(sqrt(2) r_loc))/r_C + Gaussian polynomial terms
    C_k (r/r_loc)^{2(k-1)} e^{-r^2/(2 r_loc^2)}, k = 1..4 (exact
    polynomial-kernel integrals).  (The long-range -Z_ion/r part is
    handled by the caller's point-charge machinery: molecular bare
    Coulomb or periodic Ewald.)"""
    C = np.atleast_2d(np.asarray(C, dtype=float))
    rloc = pp["rloc"]
    zion = pp["zion"]
    eta = 1.0 / (2.0 * rloc * rloc)
    # nuc_block returns the ATTRACTION -sum Z v(r); with charge -Z_ion it
    # gives +Z_ion * erfc-kernel
    out = nuc_block(sh1, sh2, [-zion] * len(C), C, shift=shift, eta=eta,
                    screen="erfc")
    for k, Ck in enumerate(pp["cloc"]):
        if Ck == 0.0:
            continue
        g = gauss_pow_block(sh1, sh2, eta, C, k=k, shift=shift)
        out = out + Ck / rloc ** (2 * k) * g
    return out


def gth_nl_block(sh1, sh2, pp, C, shift1=None, shift2=None):
    """Nonlocal projector contribution sum_lm,ij <a|p_i^lm> h^l_ij
    <p_j^lm|b> for one atom (all channels)."""
    out = np.zeros((sh1.nc, sh2.nc))
    a1 = _shifted(sh1, shift1)
    a2 = _shifted(sh2, shift2)
    for h, l, comps in gth_channels(pp, C):
        np_ = h.shape[0]
        # P[i][m, nc] = <p_i^lm | AO components>
        Pa = [W @ ovlp_block(shp, a1) for shp, W in comps]
        Pb = [W @ ovlp_block(shp, a2) for shp, W in comps]
        for i in range(np_):
            for j in range(np_):
                if h[i, j] == 0.0:
                    continue
                out += h[i, j] * (Pa[i].T @ Pb[j])
    return out


def gth_pp_molecular(mol, pseudo="gth-pade"):
    """Full molecular PP matrix: long-range point-charge attraction with
    Z_ion + short-ranged local remainder + nonlocal projectors.  Returns
    (V_pp, zions) -- use zions for the nuclear repulsion."""
    assert pseudo == "gth-pade"
    pps = [GTH_PADE[sym] for sym, _ in mol.atoms]
    zions = np.asarray([pp["zion"] for pp in pps])
    nao = mol.nao
    V = np.zeros((nao, nao))
    for i, shi in enumerate(mol.shells):
        i0, i1 = mol.shell_slices[i]
        for j, shj in enumerate(mol.shells):
            if j > i:
                continue
            j0, j1 = mol.shell_slices[j]
            blk = nuc_block(shi, shj, zions, mol.coords)
            for A, pp in enumerate(pps):
                blk = blk + gth_loc_sr_block(shi, shj, pp, mol.coords[A])
                blk = blk + gth_nl_block(shi, shj, pp, mol.coords[A])
            V[i0:i1, j0:j1] = blk
            if i != j:
                V[j0:j1, i0:i1] = blk.T
    return V, zions
