"""
The PyTorch port's Fermi-density operators and DFT tables
(libdmet_preview_tpu_torch/ops/zlinalg.py, ops/fourier.py) against the JAX
package's (libdmet_preview_tpu/ops/zlinalg.py) on identical NumPy inputs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _sym_h(n, seed, degenerate):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, n)
    h = (h + h.T) / 2
    if degenerate:
        w, V = np.linalg.eigh(h)
        w[4] = w[5]                       # exact degeneracy
        h = V @ np.diag(w) @ V.T
    return h, rng


@pytest.mark.parametrize("degenerate", [False, True])
def test_rho_fermi_real_value_and_grad(degenerate):
    """Forward rho and mu, and the autograd gradient through the
    Daleckii-Krein backward (rho cotangent and mu cotangent), vs the JAX
    custom_vjp; tolerance 1e-10.

    nelec2 = 11 puts mu among levels 4 and 5 (the exactly degenerate pair
    in the degenerate case), where N(mu) is steep and mu well-conditioned:
    with mu in a gap the slope is ~1e-6 and roundoff in either package
    moves mu by ~1e-10."""
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real as rfr_j
    from libdmet_preview_tpu_torch.ops.zlinalg import rho_fermi_real as rfr_t
    n, nelec2, beta = 14, 11, 40.0
    h, rng = _sym_h(n, 3, degenerate)
    tgt = rng.randn(n, n)
    tgt = (tgt + tgt.T) / 2

    r_j, mu_j = rfr_j(jnp.asarray(h), nelec2, beta)
    r_t, mu_t = rfr_t(_t(h), nelec2, beta)
    assert np.max(np.abs(r_t.numpy() - np.asarray(r_j))) < 1e-10
    assert abs(float(mu_t) - float(mu_j)) < 1e-10

    def obj_j(x):
        r, mu = rfr_j(x, nelec2, beta)
        return jnp.sum((r - tgt) ** 2) + 0.3 * mu

    g_j = np.asarray(jax.grad(obj_j)(jnp.asarray(h)))
    ht = _t(h).requires_grad_(True)
    r, mu = rfr_t(ht, nelec2, beta)
    (torch.sum((r - _t(tgt)) ** 2) + 0.3 * mu).backward()
    assert np.max(np.abs(ht.grad.numpy() - g_j)) < 1e-10


def test_zrho_fermi_w_tr_mesh():
    """The weighted k-space Fermi density on a time-reversal reduced mesh
    (complex eigh on the single spectrum in the port, the doubled real
    embedding in the JAX package); tolerance 1e-10."""
    from libdmet_preview_tpu.ops import zlinalg as zl_j
    from libdmet_preview_tpu_torch.ops import zlinalg as zl_t
    rng = np.random.RandomState(17)
    nk, n, beta = 8, 3, 80.0
    h_R = rng.randn(nk, n, n) * 0.4
    for R in range(1, nk // 2):
        h_R[nk - R] = h_R[R].T
    # the self-paired cells R = 0 and R = nk/2 are symmetric, so every
    # H(k) is Hermitian
    for R in (0, nk // 2):
        h_R[R] = 0.5 * (h_R[R] + h_R[R].T)
    f_re, f_im = (np.asarray(x) for x in zl_j.R2k(h_R, (nk,)))
    nelec = float(nk * n)   # half filling on the doubled spectrum
    idx = list(range(nk // 2 + 1))
    w = np.asarray([1.0] + [2.0] * (nk // 2 - 1) + [1.0])

    out_j = zl_j.zrho_fermi_w(jnp.asarray(f_re[idx]), jnp.asarray(f_im[idx]),
                              nelec, beta, jnp.asarray(w))
    out_t = zl_t.zrho_fermi_w(_t(f_re[idx]), _t(f_im[idx]), nelec, beta,
                              _t(w))
    for a, b in zip(out_t, out_j):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-10


@pytest.mark.parametrize("weighted", [False, True])
def test_bisect_mu(weighted):
    """The 6 x 256 parallel grid search for mu; tolerance 1e-12."""
    from libdmet_preview_tpu.ops.zlinalg import _bisect_mu as bis_j
    from libdmet_preview_tpu_torch.ops.zlinalg import _bisect_mu as bis_t
    rng = np.random.RandomState(5)
    ew = np.sort(rng.randn(6, 10), axis=-1)
    w = rng.rand(6) + 0.5 if weighted else None
    nelec = 17.0 if not weighted else 0.4 * float(np.sum(w) * 10)
    for beta in (10.0, 1000.0):
        mu_j = bis_j(jnp.asarray(ew), nelec, beta,
                     weights=None if w is None else jnp.asarray(w))
        mu_t = bis_t(_t(ew), nelec, beta,
                     weights=None if w is None else _t(w))
        assert abs(float(mu_t) - float(mu_j)) < 1e-12


def test_dft_tables_and_R2k_k2R():
    """DFT phase tables are identical; the port's NumPy R2k / k2R agree
    with the JAX package's to 1e-12 on a spin-batched stripe."""
    from libdmet_preview_tpu.ops import zlinalg as zl_j
    from libdmet_preview_tpu_torch.ops import fourier, zlinalg as zl_t
    kmesh = (3, 4)
    for a, b in zip(zl_t.dft_tables(kmesh), zl_j.dft_tables(kmesh)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(2)
    A = rng.randn(2, 12, 3, 3)
    re_t, im_t = fourier.R2k(A, kmesh)
    re_j, im_j = zl_j.R2k(A, kmesh)
    assert np.max(np.abs(re_t - np.asarray(re_j))) < 1e-12
    assert np.max(np.abs(im_t - np.asarray(im_j))) < 1e-12
    back_t = fourier.k2R((re_t, im_t), kmesh)
    back_j = np.asarray(zl_j.k2R((re_j, im_j), kmesh))
    assert np.max(np.abs(back_t - back_j)) < 1e-12
    assert np.max(np.abs(back_t - A)) < 1e-12
