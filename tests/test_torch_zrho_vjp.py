"""
The PyTorch port's k-space Fermi density with its Daleckii-Krein backward
(libdmet_preview_tpu_torch/ops/zlinalg.py: zrho_fermi, zrho_fermi_w, one
torch.autograd.Function on the single complex spectrum) against the JAX
package's custom_vjp ops (2n x 2n real embedding) on identical NumPy
inputs: forward 1e-10, backward 1e-8, including an exactly degenerate
k / -k pair, the mu cotangent and central finite differences.  jax is
imported inside the tests that compare with it, so that the card's test
runs where jax is not installed.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NELEC2 = 10.0          # doubled-spectrum count: 5 electrons over 5 x 4 levels


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _hermitian_batch(nk, n, seed, degenerate):
    """(h_re, h_im, cotangents, weights): H(k) Hermitian; with degenerate,
    H[3] = H[1]* (the exact k / -k pair of a time-reversal-symmetric
    mesh: equal spectra)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(nk, n, n) + 1j * rng.randn(nk, n, n)
    H = A + A.conj().transpose(0, 2, 1)
    if degenerate:
        H[3] = H[1].conj()
    cot = (rng.randn(nk, n, n), rng.randn(nk, n, n), 0.7)
    w = np.array([1.0, 2.0, 2.0, 2.0, 1.0])
    return H.real.copy(), H.imag.copy(), cot, w


def _jax_op(weights, beta):
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import zlinalg as jz
    if weights is None:
        return lambda a, b: jz.zrho_fermi(a, b, NELEC2, beta)
    return lambda a, b: jz.zrho_fermi_w(a, b, NELEC2, beta,
                                        jnp.asarray(weights))


def _torch_op(weights, beta):
    from libdmet_preview_tpu_torch.ops import zlinalg as tz
    if weights is None:
        return lambda a, b: tz.zrho_fermi(a, b, NELEC2, beta)
    return lambda a, b: tz.zrho_fermi_w(a, b, NELEC2, beta, _t(weights))


def _loss_t(op, hr, hi, cot):
    r = op(hr, hi)
    return (r[0] * _t(cot[0])).sum() + (r[1] * _t(cot[1])).sum() \
        + cot[2] * r[2]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("beta", [5.0, 50.0])
def test_zrho_fermi_forward_and_backward_match_jax(beta, degenerate,
                                                   weighted):
    """rho, mu at 1e-10 and the gradient of a random linear functional of
    (rho_re, rho_im, mu) with respect to h_re and h_im at 1e-8."""
    import jax
    import jax.numpy as jnp
    hr, hi, cot, w = _hermitian_batch(5, 4, 0, degenerate)
    w = w if weighted else None
    op_j, op_t = _jax_op(w, beta), _torch_op(w, beta)

    out_j = op_j(jnp.asarray(hr), jnp.asarray(hi))
    a, b = _t(hr).requires_grad_(True), _t(hi).requires_grad_(True)
    out_t = op_t(a, b)
    for x_t, x_j in zip(out_t, out_j):
        assert np.abs(x_t.detach().numpy() - np.asarray(x_j)).max() < 1e-10

    def loss_j(x, y):
        r = op_j(x, y)
        return jnp.sum(r[0] * cot[0]) + jnp.sum(r[1] * cot[1]) + cot[2] * r[2]

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(hr), jnp.asarray(hi))
    _loss_t(op_t, a, b, cot).backward()
    assert np.abs(a.grad.numpy() - np.asarray(g_j[0])).max() < 1e-8
    assert np.abs(b.grad.numpy() - np.asarray(g_j[1])).max() < 1e-8


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("degenerate", [False, True])
def test_zrho_fermi_backward_vs_finite_differences(degenerate, weighted):
    """The directional derivative along a random HERMITIAN perturbation
    (dh_re symmetric, dh_im antisymmetric; for the degenerate case the
    pair is perturbed together, as a vcor does) against central
    differences, 1e-6 relative."""
    hr, hi, cot, w = _hermitian_batch(5, 4, 1, degenerate)
    op_t = _torch_op(w if weighted else None, 20.0)
    rng = np.random.RandomState(11)
    D = rng.randn(5, 4, 4) + 1j * rng.randn(5, 4, 4)
    D = D + D.conj().transpose(0, 2, 1)
    if degenerate:
        D[3] = D[1].conj()
    a, b = _t(hr).requires_grad_(True), _t(hi).requires_grad_(True)
    _loss_t(op_t, a, b, cot).backward()
    ana = float((a.grad * _t(D.real)).sum() + (b.grad * _t(D.imag)).sum())
    eps = 1e-5
    with torch.no_grad():
        fp = float(_loss_t(op_t, _t(hr + eps * D.real),
                           _t(hi + eps * D.imag), cot))
        fm = float(_loss_t(op_t, _t(hr - eps * D.real),
                           _t(hi - eps * D.imag), cot))
    num = (fp - fm) / (2 * eps)
    assert abs(ana - num) < 1e-6 * max(1.0, abs(num))


def test_zrho_fermi_weighted_tr_mesh():
    """Time-reversal-reduced mesh: the IBZ with weights (2 for paired k, 1
    for self-paired) gives the full mesh's mu and densities, and the
    gradient of a functional of the IBZ densities agrees with the JAX
    package (1e-8).  The self-paired blocks of h_R are symmetrized so that
    every H(k) is Hermitian."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import zlinalg as jz
    from libdmet_preview_tpu_torch.ops import zlinalg as tz
    from libdmet_preview_tpu_torch.ops import fourier
    nk, n, beta = 6, 3, 15.0
    rng = np.random.RandomState(4)
    h_R = rng.randn(nk, n, n) * 0.5
    neg = (-np.arange(nk)) % nk
    h_R = 0.5 * (h_R + h_R[neg].transpose(0, 2, 1))     # Hermitian H(k)
    h_re, h_im = fourier.R2k(h_R, (nk,))
    ibz = np.asarray([k for k in range(nk) if k <= neg[k]])
    wts = np.where(neg[ibz] == ibz, 1.0, 2.0)
    nelec2 = 2.0 * nk * n * 0.5

    full = tz.zrho_fermi(_t(h_re), _t(h_im), nelec2, beta)
    a = _t(h_re[ibz]).requires_grad_(True)
    b = _t(h_im[ibz]).requires_grad_(True)
    red = tz.zrho_fermi_w(a, b, nelec2, beta, _t(wts))
    assert abs(float(red[2]) - float(full[2])) < 1e-10
    assert np.abs(red[0].detach().numpy() - full[0].numpy()[ibz]).max() < 1e-10
    assert np.abs(red[1].detach().numpy() - full[1].numpy()[ibz]).max() < 1e-10

    tgt = rng.randn(len(ibz), n, n)

    def loss_j(x, y):
        r = jz.zrho_fermi_w(x, y, nelec2, beta, jnp.asarray(wts))
        return jnp.sum((r[0] - tgt) ** 2) + jnp.sum(r[1] ** 2) + 0.2 * r[2]

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(h_re[ibz]),
                                           jnp.asarray(h_im[ibz]))
    (torch.sum((red[0] - _t(tgt)) ** 2) + torch.sum(red[1] ** 2)
     + 0.2 * red[2]).backward()
    assert np.abs(a.grad.numpy() - np.asarray(g_j[0])).max() < 1e-8
    assert np.abs(b.grad.numpy() - np.asarray(g_j[1])).max() < 1e-8


def test_zrho_fermi_real_input_matches_rho_fermi_real():
    """With h_im = 0 the k-space op reduces to the real-symmetric one:
    same density, mu and gradient (1e-10)."""
    from libdmet_preview_tpu_torch.ops import zlinalg as tz
    rng = np.random.RandomState(8)
    h = rng.randn(6, 6)
    h = 0.5 * (h + h.T)
    tgt = _t(rng.randn(6, 6))
    x = _t(h).requires_grad_(True)
    r, mu = tz.rho_fermi_real(x, 6.0, 12.0)
    (torch.sum(r * tgt) + 0.4 * mu).backward()
    y = _t(h).requires_grad_(True)
    r2 = tz.zrho_fermi(y, torch.zeros_like(y), 6.0, 12.0)
    (torch.sum(r2[0] * tgt) + 0.4 * r2[2]).backward()
    assert np.abs(r.detach().numpy() - r2[0].detach().numpy()).max() < 1e-10
    assert abs(float(mu) - float(r2[2])) < 1e-10
    assert np.abs(x.grad.numpy() - y.grad.numpy()).max() < 1e-10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zrho_fermi_backward_cuda_matches_cpu(cuda_device):
    """The same forward and backward on the card and on the CPU at the
    40 x 40 lattice's batch (800 Hermitian 4 x 4 blocks): 1e-9."""
    from libdmet_preview_tpu_torch.ops import zlinalg as tz
    rng = np.random.RandomState(2)
    A = rng.randn(800, 4, 4) + 1j * rng.randn(800, 4, 4)
    H = A + A.conj().transpose(0, 2, 1)
    tgt = rng.randn(800, 4, 4)
    grads = []
    for dev in ("cpu", cuda_device):
        a = _t(H.real).to(dev).requires_grad_(True)
        b = _t(H.imag).to(dev).requires_grad_(True)
        r = tz.zrho_fermi(a, b, 3200.0, 30.0)
        (torch.sum((r[0] - _t(tgt).to(dev)) ** 2) + torch.sum(r[1] ** 2)
         + r[2]).backward()
        grads.append((a.grad.cpu().numpy(), b.grad.cpu().numpy()))
    assert np.abs(grads[0][0] - grads[1][0]).max() < 1e-9
    assert np.abs(grads[0][1] - grads[1][1]).max() < 1e-9
