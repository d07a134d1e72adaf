"""
Fermi-density operators and DFT phase tables (PyTorch port of
libdmet_preview_tpu/ops/zlinalg.py).

The JAX package carries every k-space matrix as a real (re, im) pair and
diagonalises the 2n x 2n real embedding [[A, -B], [B, A]] because its
accelerator has no complex128.  CUDA and LAPACK have complex128, so the
port diagonalises H = A + iB directly with a complex Hermitian eigh.  The
public electron count keeps the JAX package's DOUBLED-spectrum convention
(`nelec2`, twice the physical count on the single spectrum); internally the
single spectrum is counted against nelec2 / 2.

Inputs and outputs stay (re, im) pairs where the JAX functions take and
return pairs, so the two packages compare one to one.  zeigh keeps the
doubled spectrum at its output for the same reason; its eigenvectors are
the complex ones of H, not the real embedding's.
"""

import itertools as it
from functools import lru_cache

import numpy as np
import torch

from libdmet_preview_tpu_torch.utils.misc import keyword_aliases


# ----------------------------------------------------------------------
# Fermi function, chemical-potential search, divided differences
# ----------------------------------------------------------------------

def _fermi(x, mu, beta):
    z = torch.clamp(beta * (x - mu), -100.0, 100.0)
    return 1.0 / (torch.exp(z) + 1.0)


def _bisect_mu(ew, nelec, beta, n_sweep=6, grid=256, weights=None):
    """Chemical potential by parallel grid refinement: each of `n_sweep`
    sweeps evaluates N(mu) on `grid` candidates at once and narrows the
    bracket to one grid cell (256^-6 of the start bracket after 6 sweeps).
    The same grid and the same clip(sum(below) - 1, 0, grid - 2) rule as
    the JAX package, so mu agrees with it; the whole search stays on the
    tensor's device with no host read.

    ew: eigenvalues (..., n); nelec: target count on THIS spectrum;
    weights: optional (...,) per-batch-element weights in the count."""
    pad = max(10.0, 1.0 / float(beta))
    lo = torch.min(ew) - pad
    hi = torch.max(ew) + pad
    flat = ew.reshape(-1)
    if weights is None:
        wflat = torch.ones_like(flat)
    else:
        wflat = weights[..., None].expand(ew.shape).reshape(-1)
    lin = torch.linspace(0.0, 1.0, grid, dtype=ew.dtype, device=ew.device)
    for _ in range(n_sweep):
        mus = lo + (hi - lo) * lin
        counts = torch.sum(wflat[None, :]
                           * _fermi(flat[None, :], mus[:, None], beta), dim=1)
        # largest grid point with count below the target (counts ascending)
        below = counts < nelec
        idx = torch.clamp(torch.sum(below) - 1, 0, grid - 2)
        # a 1-D index tensor keeps the gather on the device (a 0-d one
        # would be read to the host as a Python int)
        lo, hi = mus[torch.stack([idx, idx + 1])]
    return 0.5 * (lo + hi)


def _fermi_K(ew, mu, beta):
    """Daleckii-Krein divided-difference table of the Fermi function
    (degenerate-safe: -> f' on the diagonal/degenerate pairs)."""
    f = _fermi(ew, mu, beta)
    lam_i = ew[..., :, None]
    lam_j = ew[..., None, :]
    dl = lam_i - lam_j
    small = torch.abs(dl) < 1e-9
    favg = 0.5 * (lam_i + lam_j)
    fp_pair = -beta * _fermi(favg, mu, beta) * (1.0 - _fermi(favg, mu, beta))
    K = torch.where(small, fp_pair,
                    (f[..., :, None] - f[..., None, :])
                    / torch.where(small, torch.ones_like(dl), dl))
    return f, K


# ----------------------------------------------------------------------
# Hermitian eigh with the doubled-spectrum convention (ops/mfd.py)
# ----------------------------------------------------------------------

def zeigh(h_re, h_im):
    """Batched Hermitian eigendecomposition of H = h_re + i h_im (..., n, n).

    Returns (w2, V): w2 (..., 2n) is the DOUBLED spectrum the JAX package's
    zeigh gives (each eigenvalue twice, ascending), V (..., n, n) the
    complex eigenvectors of H (columns, ascending)."""
    ew, V = torch.linalg.eigh(torch.complex(h_re, h_im))
    return torch.repeat_interleave(ew, 2, dim=-1), V


def zfunc_from_eig(V, f2):
    """Matrix function F(H) = V diag(f) V^H from zeigh's eigenvectors and
    function values f2 (..., 2n) on the doubled spectrum (paired levels
    carry equal values; each physical level takes the pair's value).
    Returns the (F_re, F_im) pair."""
    f = (0.5 * (f2[..., 0::2] + f2[..., 1::2])).to(V.dtype)
    F = (V * f[..., None, :]) @ V.conj().transpose(-1, -2)
    return F.real, F.imag


# ----------------------------------------------------------------------
# k-space Fermi density with the Daleckii-Krein backward
# ----------------------------------------------------------------------

def _safe_inv(denom):
    safe = torch.abs(denom) > 1e-300
    return torch.where(
        safe, 1.0 / torch.where(safe, denom, torch.ones_like(denom)),
        torch.zeros_like(denom))


def _zrho_eig(h_re, h_im, nelec2, beta, weights=None, gather=None):
    """The forward of the Fermi density: (ew, V, mu, occ, rho) with rho =
    V f(ew - mu) V^H of the complex eigh of H = h_re + i h_im.  gather maps
    the spectrum to the one mu is counted on (parallel.kmesh: every rank's
    k shard)."""
    ew, V = torch.linalg.eigh(torch.complex(h_re, h_im))
    mu = _bisect_mu(ew if gather is None else gather(ew), 0.5 * nelec2,
                    beta, weights=weights)
    occ = _fermi(ew, mu, beta)
    rho = (V * occ[..., None, :].to(V.dtype)) @ V.mH
    return ew, V, mu, occ, rho


def _zrho_vjp(ew, V, mu, beta, w_re, w_im, w_mu, weights=None, reduce=None):
    """The backward of the Fermi density (the formula of _ZRhoFermi);
    reduce sums the two k sums of the mu feedback over the k points held
    elsewhere (parallel.kmesh).  Returns (gh_re, gh_im)."""
    f, K = _fermi_K(ew, mu, beta)
    fp = -beta * f * (1.0 - f)
    wfp = fp if weights is None else weights[..., None] * fp
    We = V.mH @ torch.complex(w_re, w_im) @ V
    sums = torch.stack([
        torch.sum(torch.diagonal(We, dim1=-2, dim2=-1).real * fp),
        torch.sum(wfp)])
    if reduce is not None:
        sums = reduce(sums)
    diag_coeff = (w_mu - sums[0]) * _safe_inv(sums[1])
    Mct = K * We + torch.diag_embed(wfp * diag_coeff)
    G = V @ Mct @ V.mH
    return G.real, G.imag


class _ZRhoFermi(torch.autograd.Function):
    """rho = f_beta(H - mu) of the Hermitian batch H = h_re + i h_im at a
    fixed (optionally k-weighted) electron count, as one differentiable op.

    The backward reuses the forward's complex eigendecomposition on the
    SINGLE spectrum and is exact for degenerate spectra (k/-k pairs).  With
    the cotangent Wc = w_re + i w_im and We = V^H Wc V,

        G_k = V_k [K_k o We_k + diag(w_k f'_k) c] V_k^H,
        c   = (w_mu - sum_k sum_i f'_ki Re We_kii) / sum_k w_k sum_i f'_ki,

    and (gh_re, gh_im) = (Re G, Im G): the vector-Jacobian product of
    (h_re, h_im) -> (rho_re, rho_im, mu) with h_re and h_im independent
    real arrays.  The doubled embedding's factor 2 cancels between c's
    numerator (each level once per pair) and its denominator."""

    @staticmethod
    def forward(ctx, h_re, h_im, nelec2, beta, weights):
        ew, V, mu, _, rho = _zrho_eig(h_re, h_im, nelec2, beta, weights)
        ctx.beta = beta
        ctx.weights = weights
        ctx.save_for_backward(ew, V, mu)
        return rho.real.contiguous(), rho.imag.contiguous(), mu

    @staticmethod
    def backward(ctx, w_re, w_im, w_mu):
        ew, V, mu = ctx.saved_tensors
        g_re, g_im = _zrho_vjp(ew, V, mu, ctx.beta, w_re, w_im, w_mu,
                               ctx.weights)
        return g_re, g_im, None, None, None


@keyword_aliases(nelec2="nelec")
def zrho_fermi_w(h_re, h_im, nelec, beta, weights):
    """Grand-canonical density rho = f_beta(H - mu) of the Hermitian batch
    H = h_re + i h_im (..., n, n) at fixed electron number, with per-batch
    weights in the count N = sum_k w_k tr f(H_k) (time-reversal reduced
    meshes: w = 2 for paired k, 1 for self-paired).  Differentiable in
    h_re and h_im; the weights enter the mu constraint only.

    nelec is the DOUBLED-spectrum count of the JAX package's zrho_fermi_w
    (the keyword nelec2= is taken too).  Returns (rho_re, rho_im, mu)."""
    return _ZRhoFermi.apply(h_re, h_im, float(nelec), float(beta), weights)


@keyword_aliases(nelec2="nelec")
def zrho_fermi(h_re, h_im, nelec, beta):
    """zrho_fermi_w with unit weights: rho = f_beta(H - mu) at the
    doubled-spectrum count nelec (or nelec2=), batched over leading axes,
    with the degenerate-safe derivative.  Returns (rho_re, rho_im, mu)."""
    return _ZRhoFermi.apply(h_re, h_im, float(nelec), float(beta), None)


# ----------------------------------------------------------------------
# real-symmetric Fermi density with the Daleckii-Krein backward
# ----------------------------------------------------------------------

class _RhoFermiReal(torch.autograd.Function):
    """Counterpart of the JAX package's custom_vjp rho_fermi_real: the
    backward reuses the forward eigendecomposition and is exact for
    degenerate spectra (divided differences + chemical-potential
    feedback from dN = 0)."""

    @staticmethod
    def forward(ctx, h, nelec2, beta):
        ew, V = torch.linalg.eigh(h)
        mu = _bisect_mu(ew, 0.5 * nelec2, beta)
        occ = _fermi(ew, mu, beta)
        rho = (V * occ[..., None, :]) @ V.transpose(-1, -2)
        ctx.beta = beta
        ctx.save_for_backward(ew, V, mu)
        return rho, mu

    @staticmethod
    def backward(ctx, w_rho, w_mu):
        ew, V, mu = ctx.saved_tensors
        beta = ctx.beta
        if w_rho is None:
            w_rho = torch.zeros_like(V)
        if w_mu is None:
            w_mu = torch.zeros_like(mu)
        f, K = _fermi_K(ew, mu, beta)
        fp = -beta * f * (1.0 - f)
        # the 2x doubled-count factors cancel between the dN = 0 numerator
        # and denominator, so the single-spectrum sums give the same dmu
        inv_denom = _safe_inv(torch.sum(fp))
        W_eig = V.transpose(-1, -2) @ w_rho @ V
        trace_term = torch.sum(torch.diagonal(W_eig, dim1=-2, dim2=-1) * fp)
        diag_coeff = (w_mu - trace_term) * inv_denom
        Mct = K * W_eig + torch.diag_embed(fp) * diag_coeff
        dh = V @ Mct @ V.transpose(-1, -2)
        return dh, None, None


def rho_fermi_real(h, nelec2, beta):
    """Fermi density of the real symmetric (n, n) matrix h at the
    doubled-spectrum count nelec2; differentiable in h.  Returns (rho, mu)."""
    return _RhoFermiReal.apply(h, float(nelec2), float(beta))


# ----------------------------------------------------------------------
# DFT phase tables for cell meshes
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def dft_tables(kmesh):
    """cos/sin tables for the C-ordered cell mesh.

    Returns (cos_kR, sin_kR), each (nk, nk), entry [k, R] for scaled kpts
    (fftfreq per axis) and integer cell positions, phase = 2*pi*k.R."""
    kmesh = tuple(int(x) for x in kmesh)
    kfrac = np.array(list(it.product(*[np.fft.fftfreq(m) for m in kmesh])))
    cells = np.array(list(it.product(*[range(m) for m in kmesh])), dtype=float)
    phase = 2.0 * np.pi * (kfrac @ cells.T)
    return np.cos(phase), np.sin(phase)
