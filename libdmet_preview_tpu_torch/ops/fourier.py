"""
k <-> R transforms for stripe lattice operators and the supercell folding
functions (PyTorch port of libdmet_preview_tpu/ops/fourier.py).

The lattice operators are transformed once per lattice set-up on the host,
as NumPy DFT-by-table on the (small) cell mesh; a torch tensor (the
embedding basis) is transformed on its own device with the same tables.
k-space results are (re, im) pairs, as in the JAX package.

Conventions (match the JAX package):
  R2k: A(k) = sum_R e^{-i k.R} A(R)
  k2R: A(R) = (1/Nk) sum_k e^{+i k.R} A(k)
The cell / k axis is the -3rd axis; leading axes (spin) are batch axes.
The folding functions (k2gamma, gamma2k, wigner_seitz_images, band_velocity,
fold_mo_k2gamma) are host NumPy on set-up-sized data, as in the JAX
package.
"""

import itertools as it

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops.zlinalg import dft_tables


def _is_tensor(A):
    return isinstance(A[0] if isinstance(A, tuple) else A, torch.Tensor)


def _pair_t(A):
    if isinstance(A, tuple):
        return A
    return A, torch.zeros_like(A)


def _tables_t(kmesh, like):
    cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
    return (torch.as_tensor(cos_t, dtype=like.dtype, device=like.device),
            torch.as_tensor(sin_t, dtype=like.dtype, device=like.device))


def _pair(A):
    if isinstance(A, tuple):
        return np.asarray(A[0], dtype=float), np.asarray(A[1], dtype=float)
    A_re = np.asarray(A, dtype=float)
    return A_re, np.zeros_like(A_re)


def R2k(A, kmesh):
    """Stripe R -> k.  A: ((spin,) ncells, n, m) real array or tensor, or
    an (re, im) pair of them.  Returns the (re, im) pair, tensors on A's
    device for tensor input."""
    if _is_tensor(A):
        A_re, A_im = _pair_t(A)
        cos_t, sin_t = _tables_t(kmesh, A_re)
        ein = torch.einsum
    else:
        A_re, A_im = _pair(A)
        cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
        ein = np.einsum
    re = (ein("kR, ...Rij -> ...kij", cos_t, A_re)
          + ein("kR, ...Rij -> ...kij", sin_t, A_im))
    im = (ein("kR, ...Rij -> ...kij", cos_t, A_im)
          - ein("kR, ...Rij -> ...kij", sin_t, A_re))
    return re, im


def k2R(A, kmesh, real=True):
    """k -> stripe R.  A is a (re, im) pair (or real array) of arrays or
    of tensors; returns the real stripe if real=True, else the (re, im)
    pair, tensors on A's device for tensor input."""
    if _is_tensor(A):
        A_re, A_im = _pair_t(A)
        cos_t, sin_t = _tables_t(kmesh, A_re)
        ein = torch.einsum
    else:
        A_re, A_im = _pair(A)
        cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
        ein = np.einsum
    nk = cos_t.shape[0]
    re = (ein("kR, ...kij -> ...Rij", cos_t, A_re)
          - ein("kR, ...kij -> ...Rij", sin_t, A_im)) / nk
    if real:
        return re
    im = (ein("kR, ...kij -> ...Rij", cos_t, A_im)
          + ein("kR, ...kij -> ...Rij", sin_t, A_re)) / nk
    return re, im


def FFTtoK(A, kmesh):
    """Stripe R -> k; returns (re, im) pair."""
    return R2k(A, kmesh)


def FFTtoT(B, kmesh):
    """k pair -> stripe R (real part)."""
    return k2R(B, kmesh, real=True)


def get_phase(kmesh):
    """Complex phase matrix e^{+i k.R} (host NumPy)."""
    cos_t, sin_t = dft_tables(tuple(int(x) for x in kmesh))
    return cos_t + 1j * sin_t


# ----------------------------------------------------------------------
# k2gamma folding / supercell functions
# ----------------------------------------------------------------------

def k2gamma(A_k, kmesh):
    """Fold a k-resolved operator ((re, im) pair) to the Gamma-point
    supercell matrix: the (nsites, nsites) block-circulant real matrix
    whose blocks are A(R)."""
    A_R = np.asarray(k2R(A_k, kmesh, real=True))
    lead = A_R.shape[:-3]
    nk, n, m = A_R.shape[-3:]
    kmesh = [int(x) for x in kmesh]
    cells = list(it.product(*[range(x) for x in kmesh]))
    idx = {c: i for i, c in enumerate(cells)}
    out = np.zeros(lead + (nk * n, nk * m))
    for i, ci in enumerate(cells):
        for j, cj in enumerate(cells):
            # lattice stripe convention: block (ci, cj) = A[(ci - cj) mod N]
            d = tuple((np.asarray(ci) - np.asarray(cj)) % kmesh)
            out[..., i * n:(i + 1) * n, j * m:(j + 1) * m] = \
                A_R[..., idx[d], :, :]
    return out


def gamma2k(A_sc, kmesh, n):
    """Inverse of k2gamma: extract the stripe from the supercell matrix
    and transform to k (assumes block-circulant A_sc)."""
    nk = int(np.prod([int(x) for x in kmesh]))
    stripe = np.asarray([A_sc[..., R * n:(R + 1) * n, 0:n]
                         for R in range(nk)])
    stripe = np.moveaxis(stripe, 0, -3)
    return R2k(stripe, kmesh)


def wigner_seitz_images(kmesh, dim_sizes=None):
    """Minimal-image cell vectors and degeneracy weights for band
    interpolation.

    Returns (R_ws list of arrays, weights) where each stripe cell index R
    maps to all equivalent images R + N*kmesh of minimal norm; weights =
    1/#images."""
    kmesh = [int(x) for x in kmesh]
    cells = list(it.product(*[range(x) for x in kmesh]))
    R_ws, weights = [], []
    for c in cells:
        c = np.asarray(c, dtype=float)
        images = []
        best = None
        for shift in it.product(*[(-1, 0, 1)] * len(kmesh)):
            img = c + np.asarray(shift) * np.asarray(kmesh)
            d = float(np.dot(img, img))
            if best is None or d < best - 1e-9:
                best = d
                images = [img]
            elif abs(d - best) <= 1e-9:
                images.append(img)
        R_ws.append(np.asarray(images))
        weights.append(1.0 / len(images))
    return R_ws, np.asarray(weights)


def band_velocity(H_R_stripe, kmesh, kpts_frac):
    """Group velocity dE_n/dk at arbitrary fractional k-points by
    Hellmann-Feynman through the Wigner-Seitz interpolated H(k).  Any
    dimension, H_R_stripe real (nk, n, n).  Returns (bands (nkpt, n),
    velocity (nkpt, dim, n))."""
    H_R = np.asarray(H_R_stripe)
    R_ws, w = wigner_seitz_images(kmesh)
    kpts = np.asarray(kpts_frac, dtype=float)
    nkpt = len(kpts)
    n = H_R.shape[-1]
    dim = kpts.shape[1]
    bands = np.zeros((nkpt, n))
    vel = np.zeros((nkpt, dim, n))
    for ik, kf in enumerate(kpts):
        Hk = np.zeros((n, n), dtype=complex)
        dHk = np.zeros((dim, n, n), dtype=complex)
        for R_imgs, wt, HR in zip(R_ws, w, H_R):
            for img in R_imgs:
                ph = np.exp(-2j * np.pi * np.dot(kf, img)) * wt
                Hk += ph * HR
                dHk += (-2j * np.pi * img)[:, None, None] * ph * HR
        ew, ev = np.linalg.eigh(Hk)
        bands[ik] = ew
        for d in range(dim):
            vel[ik, d] = np.real(np.einsum("pi, pq, qi -> i",
                                           ev.conj(), dHk[d], ev))
    return bands, vel


def fold_mo_k2gamma(C_k, mo_energy, kmesh, make_real=True):
    """Fold k-resolved MOs to Gamma-point supercell MOs.

    C_k: (re, im) pair (nk, n, nmo); mo_energy: (nk, nmo).
    Returns (C_sc, e_sc, ok): C_sc (nk*n, nk*nmo) supercell MO matrix
    (columns energy-sorted), e_sc the sorted energies, ok per-column
    real-gauge success flags (time-reversal-paired columns are real up to
    gauge; make_real rotates each degenerate group to a real basis)."""
    C_re, C_im = np.asarray(C_k[0]), np.asarray(C_k[1])
    nk, n, nmo = C_re.shape
    kmesh = [int(x) for x in kmesh]
    kfrac = np.asarray(list(it.product(*[np.fft.fftfreq(m)
                                         for m in kmesh])))
    cells = np.asarray(list(it.product(*[range(m) for m in kmesh])),
                       dtype=float)
    phase = np.exp(2j * np.pi * (cells @ kfrac.T)) / np.sqrt(nk)  # (R, k)
    C = C_re + 1j * C_im
    # C_sc[(R p), (k m)] = e^{+ik.R} C_k[p, m] / sqrt(nk)
    C_sc = np.einsum("Rk, kpm -> Rpkm", phase, C).reshape(nk * n, nk * nmo)
    e_sc = np.asarray(mo_energy).reshape(nk * nmo)
    order = np.argsort(e_sc, kind="mergesort")
    C_sc = C_sc[:, order]
    e_sc = e_sc[order]
    if not make_real:
        return C_sc, e_sc, None
    # k/-k partner columns are degenerate; rotate each degenerate group
    # to a real basis (exists by time reversal)
    re = C_sc.real.copy()
    ok = np.zeros(nk * nmo, dtype=bool)
    start = 0
    tolg = 1e-8 * max(1.0, float(np.abs(e_sc).max()))
    for i in range(1, nk * nmo + 1):
        if i == nk * nmo or e_sc[i] - e_sc[start] > tolg:
            blk = C_sc[:, start:i]
            # real span: eigenvectors of the real part of the projector
            P = (blk @ blk.conj().T).real
            w, v = np.linalg.eigh(P)
            nb = i - start
            re[:, start:i] = v[:, -nb:]
            ok[start:i] = w[-nb:] > 1.0 - 1e-7
            start = i
    return re, e_sc, ok
