"""
General-angular-momentum Gaussian integrals (McMurchie-Davidson); PyTorch
port of libdmet_preview_tpu/ints/md.py, kept as host NumPy.

Extends the s-only engine (ints/gto.py) to arbitrary l Cartesian shells:
overlap, kinetic, nuclear attraction (incl. erf-screened kernels for Ewald
splitting and GTH local pseudopotentials) and ERIs, via Hermite expansion
coefficients E_t^{ij} and Hermite Coulomb integrals R_{tuv}.  This owns the
capability the reference gets from PySCF's libcgto (SURVEY 2.8 item 1) for
the sp(d) bases the ab initio workloads need (GTH-SZV diamond, STO-3G
molecules, 3-band cuprates).

Validation strategy (tests/test_md.py): p/d integrals are EXACTLY related
to center-derivatives of lower-l integrals (a Cartesian Gaussian x^i G is
a linear combination of d/dAx of x^{i-1} G and x^{i-2} G terms), so every
matrix element is checked against finite differences of the independently
validated s-only engine -- a machine-precision, self-contained oracle --
plus rotational invariance of total energies and the PySCF-documented
H2O/STO-3G RHF anchor.

Host NumPy: AO integrals are one-time inputs of the device path.  The
image sums (*_imgs, the erfc-screened ERI) serve the periodic engine.
"""

import numpy as np

__all__ = ["MoleGeneral", "CART", "ncart"]


# Cartesian component exponents per l, in canonical order
CART = {
    0: [(0, 0, 0)],
    1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
    2: [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2)],
    3: [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
        (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)],
    4: [(4, 0, 0), (3, 1, 0), (3, 0, 1), (2, 2, 0), (2, 1, 1), (2, 0, 2),
        (1, 3, 0), (1, 2, 1), (1, 1, 2), (1, 0, 3), (0, 4, 0), (0, 3, 1),
        (0, 2, 2), (0, 1, 3), (0, 0, 4)],
}


def ncart(l):
    return (l + 1) * (l + 2) // 2


def dfact(n):
    """(2n-1)!! with dfact(0) = 1."""
    out = 1.0
    for k in range(2 * n - 1, 0, -2):
        out *= k
    return out


def norm_cart(a, lmn):
    """Normalization of the primitive Cartesian Gaussian
    x^l y^m z^n exp(-a r^2)."""
    l, m, n = lmn
    L = l + m + n
    return ((2.0 * a / np.pi) ** 0.75
            * (4.0 * a) ** (L / 2.0)
            / np.sqrt(dfact(l) * dfact(m) * dfact(n)))


def boys(n, x):
    """Boys functions F_0..F_n(x), vectorized and fast.

    x < 35: series for F_n + stable DOWNWARD recursion
            F_m = (2x F_{m+1} + e^{-x}) / (2m + 1);
    x >= 35: asymptotic F_0 = (1/2) sqrt(pi/x) (erf -> 1 to < 1e-16)
            + stable UPWARD recursion F_{m+1} = ((2m+1) F_m - e^{-x})/(2x).
    Replaces the scipy.gammainc route (the per-element gamma calls
    dominated the periodic short-range assembly)."""
    x = np.asarray(x, dtype=float)
    scalar = x.ndim == 0
    x = np.atleast_1d(x)
    out = np.empty((n + 1,) + x.shape)
    small = x < 35.0
    xs = np.where(small, x, 0.0)
    ex = np.exp(-xs)
    # series: F_n(x) = e^{-x} sum_k (2x)^k / [(2n+1)(2n+3)...(2n+2k+1)]
    term = np.full(x.shape, 1.0 / (2 * n + 1))
    acc = term.copy()
    tx = 2.0 * xs
    for k in range(1, 140):
        term = term * tx / (2 * n + 2 * k + 1)
        acc += term
        if k > 40 and term.max() < 1e-18:
            break
    Fn_small = ex * acc
    out[n] = Fn_small
    for m in range(n - 1, -1, -1):
        out[m] = (tx * out[m + 1] + ex) / (2 * m + 1)
    if not np.all(small):
        xl = np.where(small, 1.0, x)
        exl = np.exp(-xl)
        Fm = 0.5 * np.sqrt(np.pi / xl)
        big = ~small
        out[0][big] = Fm[big]
        for m in range(n):
            Fm = ((2 * m + 1) * Fm - exl) / (2.0 * xl)
            out[m + 1][big] = Fm[big]
    if scalar:
        out = out[..., 0]
    return out


def E_table(l1, l2, Q, a, b):
    """Hermite expansion coefficients E_t^{ij} for one Cartesian direction.

    Q = A - B may be a scalar or an ARRAY (e.g. one entry per lattice
    image); returns E[i, j, t] with Q's shape appended, i <= l1,
    j <= l2, t <= i + j."""
    p = a + b
    mu = a * b / p
    Q = np.asarray(Q, dtype=float)
    E = np.zeros((l1 + 1, l2 + 1, l1 + l2 + 2) + Q.shape)
    E[0, 0, 0] = np.exp(-mu * Q * Q)
    for i in range(l1 + 1):
        for j in range(l2 + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                # raise i
                for t in range(i + j + 1):
                    E[i, j, t] = (
                        (E[i - 1, j, t - 1] / (2 * p) if t > 0 else 0.0)
                        - (b / p) * Q * E[i - 1, j, t]
                        + (t + 1) * E[i - 1, j, t + 1])
            else:
                for t in range(i + j + 1):
                    E[i, j, t] = (
                        (E[i, j - 1, t - 1] / (2 * p) if t > 0 else 0.0)
                        + (a / p) * Q * E[i, j - 1, t]
                        + (t + 1) * E[i, j - 1, t + 1])
    return E


def R_table(tmax, umax, vmax, alpha, PC, kernel="coulomb", poly=None):
    """Hermite kernel integrals R_{tuv} = (d/dPx)^t (d/dPy)^u (d/dPz)^v
    R_000 with R^n_000 = (-2 alpha)^n F_n(alpha |PC|^2).

    kernel='coulomb': F_n = Boys functions (1/r kernel).
    kernel='gauss':   F_n(x) = e^{-x} (a Gaussian kernel e^{-alpha r^2};
                      satisfies the same dF_n/dx = -F_{n+1} chain).
                      Supports complex alpha (for complex-step
                      derivatives w.r.t. the kernel exponent).
                      With `poly` = [q0, q1, ...], the base function is
                      F_0(x) = e^{-x} Q(x) with Q(x) = sum_j q_j x^j;
                      the chain is F_{n+1} = e^{-x} (Q_n - Q_n') with
                      Q_0 = Q (exact r^{2k}-weighted Gaussian kernels
                      for the GTH C3/C4 local terms, ints/gth.py).
    PC: (..., 3).  Returns R[t, u, v] with trailing batch shape."""
    cplx = kernel == "gauss" and np.iscomplexobj(np.asarray(alpha))
    PC = np.asarray(PC, dtype=complex if cplx else float)
    batch = PC.shape[:-1]
    nmax = tmax + umax + vmax
    T = alpha * np.sum(PC * PC, axis=-1)
    if kernel == "coulomb":
        F = boys(nmax, T)                  # (nmax+1,) + batch
    elif poly is not None:
        ex = np.exp(-T)
        q = np.asarray(poly, dtype=ex.dtype)
        F = np.empty((nmax + 1,) + np.shape(T), dtype=ex.dtype)
        for n in range(nmax + 1):
            # Horner evaluation of Q_n, then Q_{n+1} = Q_n - Q_n'
            acc = np.zeros_like(T)
            for c in q[::-1]:
                acc = acc * T + c
            F[n] = ex * acc
            dq = q[1:] * np.arange(1, q.size)
            q = q.copy()
            q[:dq.size] -= dq
        F = np.broadcast_to(F, (nmax + 1,) + batch).copy()
    else:
        F = np.broadcast_to(np.exp(-T), (nmax + 1,) + batch).copy()
    # R^n accumulators.  The downward recursion is vectorized per
    # direction: for t >= 1 the t-axis rule applies uniformly over all
    # (u, v) (and analogously u over v at t = 0, v alone at t = u = 0),
    # so each n costs three strided array statements instead of a
    # Python loop over every (t, u, v) (the former molecular-ERI
    # hotspot).  Entries with t+u+v > nmax-n are computed from other
    # such entries but never read by any valid one (valid entries only
    # reference sums one or two lower at level n+1).
    Rn = np.zeros((nmax + 1, tmax + 1, umax + 1, vmax + 1) + batch,
                  dtype=F.dtype)
    for n in range(nmax + 1):
        Rn[n, 0, 0, 0] = (-2.0 * alpha) ** n * F[n]
    x, y, z = PC[..., 0], PC[..., 1], PC[..., 2]
    tc = np.arange(2, tmax + 1, dtype=float) - 1.0
    uc = np.arange(2, umax + 1, dtype=float) - 1.0
    vc = np.arange(2, vmax + 1, dtype=float) - 1.0
    tcb = tc.reshape((-1, 1, 1) + (1,) * len(batch))
    ucb = uc.reshape((-1, 1) + (1,) * len(batch))
    vcb = vc.reshape((-1,) + (1,) * len(batch))
    for n in range(nmax - 1, -1, -1):
        if tmax > 0:
            Rn[n, 1:] = x * Rn[n + 1, :tmax]
            if tmax > 1:
                Rn[n, 2:] += tcb * Rn[n + 1, :tmax - 1]
        if umax > 0:
            Rn[n, 0, 1:] = y * Rn[n + 1, 0, :umax]
            if umax > 1:
                Rn[n, 0, 2:] += ucb * Rn[n + 1, 0, :umax - 1]
        if vmax > 0:
            Rn[n, 0, 0, 1:] = z * Rn[n + 1, 0, 0, :vmax]
            if vmax > 1:
                Rn[n, 0, 0, 2:] += vcb * Rn[n + 1, 0, 0, :vmax - 1]
    return Rn[0]


class Shell(object):
    __slots__ = ("center", "l", "exps", "coefs", "nc")

    def __init__(self, center, l, prims):
        self.center = np.asarray(center, dtype=float)
        self.l = int(l)
        self.exps = np.asarray([p[0] for p in prims])
        raw = np.asarray([p[1] for p in prims])
        # normalize primitives on the (l,0,0) component, then the
        # contracted function
        lmn0 = (self.l, 0, 0)
        cn = raw * np.asarray([norm_cart(a, lmn0) for a in self.exps])
        s = 0.0
        for ai, ci in zip(self.exps, cn):
            for aj, cj in zip(self.exps, cn):
                p = ai + aj
                s += ci * cj * (np.pi / p) ** 1.5 \
                    * dfact(self.l) / (2.0 * p) ** self.l
        self.coefs = cn / np.sqrt(s)
        self.nc = ncart(self.l)


def _shifted(sh, shift):
    """Copy of a shell translated by `shift` (None = unchanged)."""
    if shift is None:
        return sh
    new = Shell.__new__(Shell)
    new.center = sh.center + np.asarray(shift, dtype=float)
    new.l = sh.l
    new.exps = sh.exps
    new.coefs = sh.coefs
    new.nc = sh.nc
    return new


def _pair_E3(sh1, sh2, shift=None):
    """All-direction E tables per primitive pair.  Returns list over
    (i-prim, j-prim) of (p, coef, P, (Ex, Ey, Ez))."""
    A = sh1.center
    B = sh2.center if shift is None else sh2.center + shift
    out = []
    for a, ca in zip(sh1.exps, sh1.coefs):
        for b, cb in zip(sh2.exps, sh2.coefs):
            p = a + b
            P = (a * A + b * B) / p
            Ex = E_table(sh1.l, sh2.l, A[0] - B[0], a, b)
            Ey = E_table(sh1.l, sh2.l, A[1] - B[1], a, b)
            Ez = E_table(sh1.l, sh2.l, A[2] - B[2], a, b)
            out.append((p, ca * cb, P, (Ex, Ey, Ez)))
    return out


def _pair_E3_imgs(sh1, sh2, shifts, logt=None):
    """Per primitive pair with shell 2 at ALL image positions B + T:
    yields (p, c12, P (nimg, 3), (Ex, Ey, Ez)) with E tables batched over
    the image axis (trailing).

    logt: optional PER-PRIMITIVE image screening -- images with Gaussian
    pair decay exp(-mu |A-B-T|^2) below e^{-logt} are dropped (tight
    primitives keep far fewer images than the shell-level cutoff)."""
    A = sh1.center
    shifts = np.atleast_2d(np.asarray(shifts, dtype=float))
    Ball = sh2.center[None, :] + shifts                 # (nimg, 3)
    d2all = np.einsum("ti, ti -> t", A[None, :] - Ball,
                      A[None, :] - Ball)
    out = []
    for a, ca in zip(sh1.exps, sh1.coefs):
        for b, cb in zip(sh2.exps, sh2.coefs):
            p = a + b
            mu = a * b / p
            if logt is not None:
                sel = np.nonzero(mu * d2all < logt)[0]
                if sel.size == 0:
                    continue
                B = Ball[sel]
            else:
                sel = np.arange(Ball.shape[0])
                B = Ball
            P = (a * A[None, :] + b * B) / p
            Es = [E_table(sh1.l, sh2.l, A[d] - B[:, d], a, b)
                  for d in range(3)]
            out.append((p, ca * cb, P, Es, sel))
    return out


def ovlp_block_imgs(sh1, sh2, shifts, logt=None):
    """Image-summed overlap block sum_T <a | b(. - T)>."""
    out = np.zeros((sh1.nc, sh2.nc))
    for p, c12, P, (Ex, Ey, Ez), _sel in _pair_E3_imgs(sh1, sh2, shifts,
                                                       logt):
        pref = c12 * (np.pi / p) ** 1.5
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                out[i, j] += pref * np.sum(
                    Ex[l1, l2, 0] * Ey[m1, m2, 0] * Ez[n1, n2, 0])
    return out


def kin_block_imgs(sh1, sh2, shifts, logt=None):
    """Image-summed kinetic block."""
    A = sh1.center
    shifts = np.atleast_2d(np.asarray(shifts, dtype=float))
    Ball = sh2.center[None, :] + shifts
    d2all = np.einsum("ti, ti -> t", A[None, :] - Ball, A[None, :] - Ball)
    out = np.zeros((sh1.nc, sh2.nc))
    for a, ca in zip(sh1.exps, sh1.coefs):
        for b, cb in zip(sh2.exps, sh2.coefs):
            p = a + b
            mu = a * b / p
            if logt is not None:
                B = Ball[mu * d2all < logt]
                if B.shape[0] == 0:
                    continue
            else:
                B = Ball
            pref = ca * cb * (np.pi / p) ** 1.5
            E3 = [E_table(sh1.l, sh2.l + 2, A[d] - B[:, d], a, b)
                  for d in range(3)]

            def S1(d, i, j):
                if i < 0 or j < 0:
                    return 0.0
                return E3[d][i, j, 0]

            def T1(d, i, j):
                return (-2.0 * b * b * S1(d, i, j + 2)
                        + b * (2 * j + 1) * S1(d, i, j)
                        - 0.5 * j * (j - 1) * S1(d, i, j - 2))

            for i, lmn1 in enumerate(CART[sh1.l]):
                for j, lmn2 in enumerate(CART[sh2.l]):
                    sx = S1(0, lmn1[0], lmn2[0])
                    sy = S1(1, lmn1[1], lmn2[1])
                    sz = S1(2, lmn1[2], lmn2[2])
                    tx = T1(0, lmn1[0], lmn2[0])
                    ty = T1(1, lmn1[1], lmn2[1])
                    tz = T1(2, lmn1[2], lmn2[2])
                    out[i, j] += pref * np.sum(
                        tx * sy * sz + sx * ty * sz + sx * sy * tz)
    return out


def nuc_block_imgs(sh1, sh2, charges, coords, shifts, eta=None,
                   screen="none", logt=None):
    """Image-summed nuclear attraction: sum_T (a| V |b(. - T)) with the
    charges at fixed positions `coords` (which may themselves enumerate
    nuclear images).  Kernel options as nuc_block."""
    coords = np.asarray(coords, dtype=float)
    charges = np.asarray(charges, dtype=float)
    out = np.zeros((sh1.nc, sh2.nc))
    lsum = sh1.l + sh2.l
    for p, c12, P, (Ex, Ey, Ez), _sel in _pair_E3_imgs(sh1, sh2, shifts,
                                                       logt):
        PC = P[:, None, :] - coords[None, :, :]         # (nimg, natm, 3)
        if screen == "none":
            terms = [(p, 1.0)]
        else:
            s = eta / (p + eta)
            if screen == "erf":
                terms = [(p * s, np.sqrt(s))]
            else:
                terms = [(p, 1.0), (p * s, -np.sqrt(s))]
        for alpha_eff, wfac in terms:
            R = R_table(lsum, lsum, lsum, alpha_eff, PC)  # [t,u,v,img,atm]
            RZ = np.einsum("tuvga, a -> tuvg", R, charges)
            fac = c12 * (2.0 * np.pi / p) * wfac
            for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
                for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                    val = 0.0
                    for t in range(l1 + l2 + 1):
                        for u in range(m1 + m2 + 1):
                            for v in range(n1 + n2 + 1):
                                E3v = Ex[l1, l2, t] * Ey[m1, m2, u] \
                                    * Ez[n1, n2, v]
                                val = val + np.sum(E3v * RZ[t, u, v])
                    out[i, j] -= fac * val
    return out


def gauss_block_imgs(sh1, sh2, beta, C, shifts, logt=None):
    """Image-summed sum_T sum_A (a| e^{-beta |r-C_A|^2} |b(. - T));
    beta may be complex (complex-step)."""
    C = np.atleast_2d(np.asarray(C, dtype=float))
    cplx = np.iscomplexobj(np.asarray(beta))
    out = np.zeros((sh1.nc, sh2.nc), dtype=complex if cplx else float)
    lsum = sh1.l + sh2.l
    for p, c12, P, (Ex, Ey, Ez), _sel in _pair_E3_imgs(sh1, sh2, shifts,
                                                       logt):
        gam = p * beta / (p + beta)
        pref = c12 * (np.pi / (p + beta)) ** 1.5
        PC = P[:, None, :] - C[None, :, :]
        R = R_table(lsum, lsum, lsum, gam, PC, kernel="gauss")
        Rs = R.sum(axis=-1)                              # over centers
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                val = 0.0
                for t in range(l1 + l2 + 1):
                    for u in range(m1 + m2 + 1):
                        for v in range(n1 + n2 + 1):
                            E3v = Ex[l1, l2, t] * Ey[m1, m2, u] \
                                * Ez[n1, n2, v]
                            val = val + np.sum(E3v * Rs[t, u, v])
                out[i, j] += pref * val
    return out


def raw_shell(center, l, alpha):
    """Single-primitive shell with UNIT coefficient (no normalization):
    its ovlp_block rows are the raw integrals <x^a y^b z^c e^{-alpha r^2}|.
    (used to expand GTH projectors into Cartesian monomials)."""
    sh = Shell.__new__(Shell)
    sh.center = np.asarray(center, dtype=float)
    sh.l = int(l)
    sh.exps = np.asarray([float(alpha)])
    sh.coefs = np.asarray([1.0])
    sh.nc = ncart(l)
    return sh


def gauss_pow_poly(k, p, beta):
    """Polynomial Q_k(x) (coefficients, ascending) such that
    int e^{-p|r-P|^2} |r-C|^{2k} e^{-beta|r-C|^2} d^3r
      = (pi/(p+beta))^{3/2} e^{-x} Q_k(x),   x = gamma |P-C|^2,
    gamma = p beta/(p+beta).  Exact Gaussian moments (k <= 3): with
    a = p+beta and mu^2 = c x, c = p/(beta (p+beta)),
      <|v+mu|^{2k}>_a = k-th moment of the shifted Gaussian."""
    a = p + beta
    c = p / (beta * (p + beta))
    if k == 0:
        return [1.0]
    if k == 1:
        return [1.5 / a, c]
    if k == 2:
        return [3.75 / a ** 2, 5.0 * c / a, c ** 2]
    if k == 3:
        return [13.125 / a ** 3, 26.25 * c / a ** 2,
                10.5 * c ** 2 / a, c ** 3]
    raise NotImplementedError("gauss_pow_poly k > 3")


def gauss_pow_block(sh1, sh2, beta, C, k=0, shift=None):
    """sum_A (a| |r - C_A|^{2k} e^{-beta |r - C_A|^2} |b), exact
    polynomial-kernel Hermite integrals (GTH local C1..C4 terms)."""
    C = np.atleast_2d(np.asarray(C, dtype=float))
    out = np.zeros((sh1.nc, sh2.nc))
    lsum = sh1.l + sh2.l
    for p, c12, P, (Ex, Ey, Ez) in _pair_E3(sh1, sh2, shift):
        gam = p * beta / (p + beta)
        pref = c12 * (np.pi / (p + beta)) ** 1.5
        R = R_table(lsum, lsum, lsum, gam, P[None, :] - C,
                    kernel="gauss", poly=gauss_pow_poly(k, p, beta))
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


def dipole_block(sh1, sh2, origin=(0.0, 0.0, 0.0), shift=None):
    """(3, nc1, nc2) dipole-operator block <a| r - origin |b>, exact via
    the monomial identity x chi_B = [mono + e_x at B] + B_x chi_B
    (raw_shell overlaps carry the l2+1 monomials)."""
    origin = np.asarray(origin, dtype=float)
    B = sh2.center if shift is None else sh2.center + np.asarray(shift,
                                                                 float)
    sh2s = _shifted(sh2, shift)
    out = np.zeros((3, sh1.nc, sh2.nc))
    hi_index = {m: k for k, m in enumerate(CART[sh2.l + 1])}
    for e, c in zip(sh2s.exps, sh2s.coefs):
        O_hi = ovlp_block(sh1, raw_shell(B, sh2.l + 1, e))
        O_lo = ovlp_block(sh1, raw_shell(B, sh2.l, e))
        for j, mono in enumerate(CART[sh2.l]):
            for d in range(3):
                up = list(mono)
                up[d] += 1
                out[d, :, j] += c * (O_hi[:, hi_index[tuple(up)]]
                                     + (B[d] - origin[d]) * O_lo[:, j])
    return out


def ovlp_block(sh1, sh2, shift=None):
    """(nc1, nc2) overlap block between two shells."""
    out = np.zeros((sh1.nc, sh2.nc))
    for p, c12, P, (Ex, Ey, Ez) in _pair_E3(sh1, sh2, shift):
        pref = c12 * (np.pi / p) ** 1.5
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                out[i, j] += pref * Ex[l1, l2, 0] * Ey[m1, m2, 0] \
                    * Ez[n1, n2, 0]
    return out


def kin_block(sh1, sh2, shift=None):
    """Kinetic energy block via the standard 1D decomposition
    T = Tx Sy Sz + Sx Ty Sz + Sx Sy Tz with
    T_ij = -2 b^2 S_{i,j+2} + b (2 j + 1) S_{ij} - j(j-1)/2 S_{i,j-2}."""
    A = sh1.center
    B = sh2.center if shift is None else sh2.center + shift
    out = np.zeros((sh1.nc, sh2.nc))
    for a, ca in zip(sh1.exps, sh1.coefs):
        for b, cb in zip(sh2.exps, sh2.coefs):
            p = a + b
            pref = ca * cb * (np.pi / p) ** 1.5
            E3 = [E_table(sh1.l, sh2.l + 2, A[d] - B[d], a, b)
                  for d in range(3)]

            def S1(d, i, j):
                if i < 0 or j < 0:
                    return 0.0
                return E3[d][i, j, 0]

            def T1(d, i, j):
                return (-2.0 * b * b * S1(d, i, j + 2)
                        + b * (2 * j + 1) * S1(d, i, j)
                        - 0.5 * j * (j - 1) * S1(d, i, j - 2))

            for i, lmn1 in enumerate(CART[sh1.l]):
                for j, lmn2 in enumerate(CART[sh2.l]):
                    sx = S1(0, lmn1[0], lmn2[0])
                    sy = S1(1, lmn1[1], lmn2[1])
                    sz = S1(2, lmn1[2], lmn2[2])
                    tx = T1(0, lmn1[0], lmn2[0])
                    ty = T1(1, lmn1[1], lmn2[1])
                    tz = T1(2, lmn1[2], lmn2[2])
                    out[i, j] += pref * (tx * sy * sz + sx * ty * sz
                                         + sx * sy * tz)
    return out


def nuc_block(sh1, sh2, charges, coords, shift=None, eta=None,
              screen="none"):
    """Nuclear-attraction block  -sum_A Z_A (a| v(|r - R_A|) |b).

    screen='none': v = 1/r (bare).
    screen='erf':  v = erf(sqrt(eta) r)/r  (long range: the bare kernel
                   with alpha_eff = p*s, s = eta/(p+eta), scaled sqrt(s)).
    screen='erfc': v = erfc(sqrt(eta) r)/r = bare - erf (Ewald SR part).
    """
    out = np.zeros((sh1.nc, sh2.nc))
    coords = np.asarray(coords, dtype=float)
    charges = np.asarray(charges, dtype=float)
    lsum = sh1.l + sh2.l
    for p, c12, P, (Ex, Ey, Ez) in _pair_E3(sh1, sh2, shift):
        PC = P[None, :] - coords                       # (natm, 3)
        if screen == "none":
            terms = [(p, 1.0)]
        else:
            s = eta / (p + eta)
            if screen == "erf":
                terms = [(p * s, np.sqrt(s))]
            elif screen == "erfc":
                terms = [(p, 1.0), (p * s, -np.sqrt(s))]
            else:
                raise ValueError(screen)
        for alpha_eff, wfac in terms:
            R = R_table(lsum, lsum, lsum, alpha_eff, PC)  # [t,u,v,natm]
            fac = c12 * (2.0 * np.pi / p) * wfac
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
                                val += ex * ey * ez * np.dot(
                                    charges, R[t, u, v])
                    out[i, j] -= fac * val
    return out


def _stack_pair_E(pairs, l1, l2, sign=False):
    """Stack _pair_E3 output into a dense Hermite-coefficient matrix:
    (npair, nc1*nc2, (l1+l2+1)^3) with the contraction coefficient
    folded in; entries with t > i+j vanish by E_table construction.
    sign=True folds (-1)^(t+u+v) (the ket side of an ERI; _eri_quartet
    applies the sign itself, so pair data cached for intor_eri is
    bra/ket agnostic)."""
    lmn1 = np.asarray(CART[l1])
    lmn2 = np.asarray(CART[l2])
    nc1, nc2 = len(lmn1), len(lmn2)
    lt = l1 + l2
    tg = np.arange(lt + 1)
    i1 = lmn1[:, :, None, None]           # (nc1, 3dir, 1, 1)
    j2 = lmn2.T[:, None, :, None]         # (3dir, 1, nc2, 1)
    n = len(pairs)
    Es = np.empty((n, nc1, nc2, lt + 1, lt + 1, lt + 1))
    ps = np.empty(n)
    cs = np.empty(n)
    Ps = np.empty((n, 3))
    for a, (p, c, P, (Ex, Ey, Ez)) in enumerate(pairs):
        exm = Ex[i1[:, 0], j2[0], tg[None, None, :]]
        eym = Ey[i1[:, 1], j2[1], tg[None, None, :]]
        ezm = Ez[i1[:, 2], j2[2], tg[None, None, :]]
        Es[a] = (exm[:, :, :, None, None] * eym[:, :, None, :, None]
                 * ezm[:, :, None, None, :])
        ps[a], cs[a], Ps[a] = p, c, P
    Es = Es.reshape(n, nc1 * nc2, (lt + 1) ** 3)
    if sign:
        s = (-1.0) ** (tg[:, None, None] + tg[None, :, None]
                       + tg[None, None, :])
        Es = Es * s.reshape(1, 1, -1)
    return Es * cs[:, None, None], ps, Ps


def eri_block(sh1, sh2, sh3, sh4, shifts=(None, None, None), omega=None):
    """Chemist-notation ERI block (sh1 sh2 | sh3 sh4), shape
    (nc1, nc2, nc3, nc4).  shifts: optional translations of sh2, sh3, sh4
    (lattice images).

    omega: None for the bare 1/r Coulomb kernel; a float for the
    LONG-RANGE erf(omega r)/r attenuated kernel (range-separation /
    MDF-class drivers; the complementary erfc short-range block is
    eri_block(...) - eri_block(..., omega=omega)).  MD formalism: the
    attenuated fundamental integral is the bare one with the Hermite
    exponent alpha -> theta = alpha w^2/(alpha + w^2) inside R_table
    ((-2 theta)^n carries the (theta/alpha)^n order scaling) times an
    overall sqrt(theta/alpha).

    Vectorized over ALL primitive quartets: one unit-exponent R_table
    call batched over the (pair12 x pair34) product via the scaling
    identity R_tuv(alpha, PC) = alpha^{(t+u+v)/2} R_tuv(1, sqrt(alpha)
    PC), a sliding-window view for the Hermite coupling matrix
    R[t+T, u+U, v+V], and one einsum for the E(12) x R x E(34)
    contraction (the former scalar Python loops were the molecular-ERI
    bottleneck: 12 s for a (p6 p6|p6 p6) quartet, now ~10 ms)."""
    from numpy.lib.stride_tricks import sliding_window_view

    l12 = sh1.l + sh2.l
    l34 = sh3.l + sh4.l
    pairs12 = _pair_E3(sh1, sh2, shifts[0])
    sh3s = _shifted(sh3, shifts[1])
    pairs34 = _pair_E3(sh3s, sh4, shifts[2])

    data12 = _stack_pair_E(pairs12, sh1.l, sh2.l)
    data34 = _stack_pair_E(pairs34, sh3s.l, sh4.l)
    out = _eri_quartet(data12, data34, l12, l34, omega=omega)
    return out.reshape(sh1.nc, sh2.nc, sh3.nc, sh4.nc)


def _eri_quartet(data12, data34, l12, l34, omega=None):
    """(nc1*nc2, nc3*nc4) ERI block from stacked pair data (the output
    of _stack_pair_E, cacheable per shell pair)."""
    from numpy.lib.stride_tricks import sliding_window_view

    E12, p12, P12 = data12
    F34, q34, Q34 = data34
    n12, n34 = len(p12), len(q34)
    nH12 = (l12 + 1) ** 3
    nH34 = (l34 + 1) ** 3

    p = p12[:, None]
    q = q34[None, :]
    alpha = p * q / (p + q)
    fac = 2.0 * np.pi ** 2.5 / (p * q * np.sqrt(p + q))
    if omega is not None:
        theta = alpha * omega ** 2 / (alpha + omega ** 2)
        fac = fac * np.sqrt(theta / alpha)
        alpha = theta
    sqa = np.sqrt(alpha).reshape(-1)                       # (nab,)
    PQ = (P12[:, None, :] - Q34[None, :, :]).reshape(-1, 3)
    L = l12 + l34
    R = R_table(L, L, L, 1.0, sqa[:, None] * PQ)           # (L+1,)*3+(nab,)
    R = np.moveaxis(R, -1, 0)
    ng = np.arange(L + 1)
    nsum = ng[:, None, None] + ng[None, :, None] + ng[None, None, :]
    R *= sqa[:, None, None, None] ** nsum
    R *= fac.reshape(-1, 1, 1, 1)

    # ket-side parity (-1)^(T+U+V) over the window cube
    tg = np.arange(l34 + 1)
    ksign = ((-1.0) ** (tg[:, None, None] + tg[None, :, None]
                        + tg[None, None, :])).reshape(-1)

    # coupling matrix R[t+T, u+U, v+V] as a window view, contracted in
    # bounded chunks over the primitive-quartet axis
    out = np.zeros((E12.shape[1], F34.shape[1]))
    nab = n12 * n34
    chunk = max(1, min(nab, int(8e6) // max(nH12 * nH34, 1)))
    for s0 in range(0, nab, chunk):
        s1 = min(s0 + chunk, nab)
        Rw = sliding_window_view(
            R[s0:s1], (l34 + 1, l34 + 1, l34 + 1),
            axis=(1, 2, 3)).reshape(s1 - s0, nH12, nH34)
        if l34 > 0:
            Rw = Rw * ksign
        a_idx, b_idx = np.divmod(np.arange(s0, s1), n34)
        # (c, nH12, nH34) @ (c, nH34, nc34) -> (c, nH12, nc34), then
        # contract (c, nH12) against the bra coefficients
        tmp = Rw @ F34[b_idx].transpose(0, 2, 1)
        out += np.tensordot(E12[a_idx], tmp, axes=([0, 2], [0, 1]))
    return out


def eri_block_erfc_tsum(sh1, sh2, sh3, sh4, shifts, Tks, omega,
                        rcut=None, tol=1e-14):
    """IMAGE-SUMMED short-range ERI block
        sum_T (sh1 sh2 | erfc(w r)/r | sh3^{+T} sh4^{+T})
    with T over `Tks` (lattice vectors), erfc = bare - erf evaluated as
    a BATCHED R-table over all images at once (the scaling path for the
    periodic range-separated driver -- one Hermite contraction per prim
    pair instead of one eri_block call per image).

    shifts = (s2, s3, s4) as eri_block; Tks shifts sh3 AND sh4 jointly.
    rcut: screen images by Hermite-center distance (default from tol)."""
    l12 = sh1.l + sh2.l
    l34 = sh3.l + sh4.l
    out = np.zeros((sh1.nc, sh2.nc, sh3.nc, sh4.nc))
    pairs12 = _pair_E3(sh1, sh2, shifts[0])
    sh3s = _shifted(sh3, shifts[1])
    pairs34 = _pair_E3(sh3s, sh4, shifts[2])
    Tks = np.asarray(Tks)
    for p, c12, P, (Ex, Ey, Ez) in pairs12:
        for q, c34, Q, (Fx, Fy, Fz) in pairs34:
            alpha = p * q / (p + q)
            theta = alpha * omega ** 2 / (alpha + omega ** 2)
            PC = (P - Q)[None, :] - Tks             # (nT, 3)
            d2 = np.einsum("ti, ti -> t", PC, PC)
            if rcut is None:
                # erfc(w r)/r < tol at w r ~ sqrt(-ln tol)
                rc = np.sqrt(-np.log(tol)) / omega \
                    + np.sqrt(-np.log(tol) / alpha)
            else:
                rc = rcut
            keep = d2 < rc * rc
            if not np.any(keep):
                continue
            Rb = R_table(l12 + l34, l12 + l34, l12 + l34, alpha,
                         PC[keep]).sum(axis=-1)
            Rl = R_table(l12 + l34, l12 + l34, l12 + l34, theta,
                         PC[keep]).sum(axis=-1)
            R = Rb - np.sqrt(theta / alpha) * Rl
            fac = c12 * c34 * 2.0 * np.pi ** 2.5 \
                / (p * q * np.sqrt(p + q))
            for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
                for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                    Etuv = []
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
                                Etuv.append((t, u, v, ex * ey * ez))
                    if not Etuv:
                        continue
                    for k, (l3, m3, n3) in enumerate(CART[sh3.l]):
                        for m, (l4, m4, n4) in enumerate(CART[sh4.l]):
                            val = 0.0
                            for tau in range(l3 + l4 + 1):
                                fx = Fx[l3, l4, tau]
                                if fx == 0.0:
                                    continue
                                for nu in range(m3 + m4 + 1):
                                    fy = Fy[m3, m4, nu]
                                    if fy == 0.0:
                                        continue
                                    for ph in range(n3 + n4 + 1):
                                        fz = Fz[n3, n4, ph]
                                        if fz == 0.0:
                                            continue
                                        ff = fx * fy * fz \
                                            * (-1.0) ** (tau + nu + ph)
                                        for t, u, v, ee in Etuv:
                                            val += ee * ff * R[
                                                t + tau, u + nu, v + ph]
                            out[i, j, k, m] += fac * val
    return out


def pair_prim_dense(sh1, sh2, shift=None):
    """Primitive-pair data for the NATIVE erfc-ERI kernel
    (_sr_core.cpp erfc_eri_rows): per primitive pair the scalars
    (p, c12, P) and the DENSE 3D Hermite E table

        E[a, i*nc2+j, t*(l12+1)^2 + u*(l12+1) + v]
            = Ex[l1,l2,t] Ey[m1,m2,u] Ez[n1,n2,v]

    Returns (pc (np12, 6) [p, c, Px, Py, Pz, max|E|],
    E (np12, nc12, h12)); max|E| feeds the kernel's magnitude-aware
    image screen."""
    l12 = sh1.l + sh2.l
    nh = l12 + 1
    prs = _pair_E3(sh1, sh2, shift)
    nc12 = sh1.nc * sh2.nc
    pc = np.empty((len(prs), 6))
    E = np.zeros((len(prs), nc12, nh ** 3))
    for a, (p, c12, P, (Ex, Ey, Ez)) in enumerate(prs):
        pc[a, 0] = p
        pc[a, 1] = c12
        pc[a, 2:5] = P
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                blk = np.einsum("t, u, v -> tuv", Ex[l1, l2, :nh],
                                Ey[m1, m2, :nh], Ez[n1, n2, :nh])
                E[a, i * sh2.nc + j] = blk.ravel()
        pc[a, 5] = np.abs(E[a]).max()
    return pc, E


def pair_prim_dense_imgs(sh1, sh2, shifts):
    """pair_prim_dense for shell 2 at every image B + T at once: (pc
    (nimg, np12, 6), E (nimg, np12, nc12, h12)), entry [t] equal to
    pair_prim_dense(sh1, sh2, shifts[t])."""
    shifts = np.atleast_2d(np.asarray(shifts, dtype=float))
    nimg = shifts.shape[0]
    l12 = sh1.l + sh2.l
    nh = l12 + 1
    prs = _pair_E3_imgs(sh1, sh2, shifts)
    nc12 = sh1.nc * sh2.nc
    pc = np.empty((nimg, len(prs), 6))
    E = np.zeros((nimg, len(prs), nc12, nh ** 3))
    for a, (p, c12, P, (Ex, Ey, Ez), _sel) in enumerate(prs):
        pc[:, a, 0] = p
        pc[:, a, 1] = c12
        pc[:, a, 2:5] = P
        for i, (l1, m1, n1) in enumerate(CART[sh1.l]):
            for j, (l2, m2, n2) in enumerate(CART[sh2.l]):
                blk = np.einsum("tT, uT, vT -> Ttuv", Ex[l1, l2, :nh],
                                Ey[m1, m2, :nh], Ez[n1, n2, :nh])
                E[:, a, i * sh2.nc + j] = blk.reshape(nimg, -1)
    pc[:, :, 5] = np.abs(E).reshape(nimg, len(prs), -1).max(axis=2)
    return pc, E


# general-l basis data: {(symbol, basis): [(l, [(exp, coef), ...]), ...]}
# (standard public STO-3G parameters; same contraction coefficients for
# all first-row atoms with element-scaled exponents)
_C1S = [0.15432897, 0.53532814, 0.44463454]
_C2S = [-0.09996723, 0.39951283, 0.70011547]
_C2P = [0.15591627, 0.60768372, 0.39195739]
GBASIS = {
    ("H", "sto-3g"): [
        (0, list(zip([3.42525091, 0.62391373, 0.16885540], _C1S)))],
    ("C", "sto-3g"): [
        (0, list(zip([71.6168370, 13.0450960, 3.5305122], _C1S))),
        (0, list(zip([2.9412494, 0.6834831, 0.2222899], _C2S))),
        (1, list(zip([2.9412494, 0.6834831, 0.2222899], _C2P)))],
    ("N", "sto-3g"): [
        (0, list(zip([99.1061690, 18.0523120, 4.8856602], _C1S))),
        (0, list(zip([3.7804559, 0.8784966, 0.2857144], _C2S))),
        (1, list(zip([3.7804559, 0.8784966, 0.2857144], _C2P)))],
    ("O", "sto-3g"): [
        (0, list(zip([130.7093200, 23.8088610, 6.4436083], _C1S))),
        (0, list(zip([5.0331513, 1.1695961, 0.3803890], _C2S))),
        (1, list(zip([5.0331513, 1.1695961, 0.3803890], _C2P)))],
    # CP2K GTH_BASIS_SETS single-zeta valence (for GTH pseudopotentials)
    ("H", "gth-szv"): [
        (0, [(8.3744350009, -0.0283380461), (1.8058681460, -0.1333810052),
             (0.4852528328, -0.3995676063)])],
    ("C", "gth-szv"): [
        (0, [(4.3362376436, 0.1490797872), (1.2881838513, -0.0292640031),
             (0.4037767149, -0.6882040510), (0.1187877657, -0.3964426906)]),
        (1, [(4.3362376436, -0.0878123619), (1.2881838513, -0.2775560300),
             (0.4037767149, -0.4712295093), (0.1187877657, -0.4058039291)])],
}


class MoleGeneral(object):
    """General-l molecule: shells from a basis dict
    {(symbol, basis): [(l, [(exp, coef), ...]), ...]} or the s-only BASIS
    table of ints/gto.py (entries without an explicit l are s shells)."""

    def __init__(self, atoms, basis="sto-3g", basis_data=None,
                 charges=None):
        from libdmet_preview_tpu_torch.ints.gto import BASIS as SBASIS, CHARGES
        self.atoms = [(sym, np.asarray(xyz, dtype=float))
                      for sym, xyz in atoms]
        self.shells = []
        self.shell_slices = []
        p0 = 0
        for sym, xyz in self.atoms:
            if basis_data is not None:
                shell_list = basis_data[(sym, basis)]
            elif (sym, basis) in GBASIS:
                shell_list = GBASIS[(sym, basis)]
            else:
                shell_list = SBASIS[(sym, basis)]
            for entry in shell_list:
                if isinstance(entry, tuple) and len(entry) == 2 \
                        and isinstance(entry[0], int):
                    l, prims = entry
                else:
                    l, prims = 0, entry
                sh = Shell(xyz, l, prims)
                self.shells.append(sh)
                self.shell_slices.append((p0, p0 + sh.nc))
                p0 += sh.nc
        self.nao = p0
        if charges is None:
            self.charges = np.asarray([CHARGES[sym]
                                       for sym, _ in self.atoms])
        else:
            self.charges = np.asarray(charges, dtype=float)
        self.coords = np.asarray([xyz for _, xyz in self.atoms])
        self.nelectron = int(round(self.charges.sum()))

    def energy_nuc(self):
        e = 0.0
        for i in range(len(self.atoms)):
            for j in range(i):
                r = np.linalg.norm(self.coords[i] - self.coords[j])
                e += self.charges[i] * self.charges[j] / r
        return e

    def _fill1(self, fn):
        out = np.zeros((self.nao, self.nao))
        for i, shi in enumerate(self.shells):
            i0, i1 = self.shell_slices[i]
            for j, shj in enumerate(self.shells):
                j0, j1 = self.shell_slices[j]
                if j > i:
                    continue
                blk = fn(shi, shj)
                out[i0:i1, j0:j1] = blk
                if i != j:
                    out[j0:j1, i0:i1] = blk.T
        return out

    def intor_ovlp(self):
        return self._fill1(ovlp_block)

    def intor_kin(self):
        return self._fill1(kin_block)

    def intor_nuc(self):
        return self._fill1(lambda a, b: nuc_block(
            a, b, self.charges, self.coords))

    def intor_hcore(self):
        return self.intor_kin() + self.intor_nuc()

    def intor_dipole(self, origin=(0.0, 0.0, 0.0)):
        """(3, nao, nao) dipole-operator matrices <a| r - origin |b>."""
        out = np.zeros((3, self.nao, self.nao))
        for i, shi in enumerate(self.shells):
            i0, i1 = self.shell_slices[i]
            for j, shj in enumerate(self.shells):
                j0, j1 = self.shell_slices[j]
                out[:, i0:i1, j0:j1] = dipole_block(shi, shj,
                                                    origin=origin)
        return out

    def ao_slices_by_atom(self):
        """[(p0, p1)] AO ranges per atom (shells are emitted atom-major
        by construction)."""
        out = []
        si = 0
        for sym, xyz in self.atoms:
            p0 = self.shell_slices[si][0]
            nsh = 0
            for sh in self.shells[si:]:
                if np.allclose(sh.center, xyz, atol=1e-12):
                    nsh += 1
                else:
                    break
            p1 = self.shell_slices[si + nsh - 1][1]
            out.append((p0, p1))
            si += nsh
        return out

    def intor_eri(self):
        n = self.nao
        eri = np.zeros((n, n, n, n))
        nsh = len(self.shells)
        # pair data (Hermite E stacks) depends only on the shell pair:
        # build each of the ~nsh^2/2 stacks once instead of per quartet
        pair = {}
        for i in range(nsh):
            for j in range(i + 1):
                pair[(i, j)] = _stack_pair_E(
                    _pair_E3(self.shells[i], self.shells[j]),
                    self.shells[i].l, self.shells[j].l)
        for i in range(nsh):
            i0, i1 = self.shell_slices[i]
            for j in range(i + 1):
                j0, j1 = self.shell_slices[j]
                l12 = self.shells[i].l + self.shells[j].l
                for k in range(nsh):
                    k0, k1 = self.shell_slices[k]
                    for m in range(k + 1):
                        m0, m1 = self.shell_slices[m]
                        if (k, m) > (i, j):
                            continue
                        l34 = self.shells[k].l + self.shells[m].l
                        blk = _eri_quartet(
                            pair[(i, j)], pair[(k, m)], l12, l34).reshape(
                                self.shells[i].nc, self.shells[j].nc,
                                self.shells[k].nc, self.shells[m].nc)
                        for (a0, a1, b0, b1, B) in (
                                (i0, i1, j0, j1, blk),
                                (j0, j1, i0, i1, blk.transpose(1, 0, 2, 3))):
                            for (c0, c1, d0, d1, BB) in (
                                    (k0, k1, m0, m1, B),
                                    (m0, m1, k0, k1,
                                     B.transpose(0, 1, 3, 2))):
                                eri[a0:a1, b0:b1, c0:c1, d0:d1] = BB
                                eri[c0:c1, d0:d1, a0:a1, b0:b1] = \
                                    BB.transpose(2, 3, 0, 1)
        return eri
