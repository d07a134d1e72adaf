"""
The PyTorch port's DF embedding-ERI syrk (libdmet_preview_tpu_torch/ops/
eri_kernels.py), symmetric and cross (unrestricted ab), against the exact
f64 einsum and against the JAX package's Pallas kernels
(libdmet_preview_tpu/ops/pallas_eri.py) run in interpret mode.  The
hand-written CUDA kernels themselves run only on a card: their tests are
marked `cuda` and skip where torch has no CUDA device.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _factors(naux, neo, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    L = rng.randn(naux, neo, neo)
    return 0.5 * (L + L.transpose(0, 2, 1)) * scale


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("naux, neo", [(40, 9), (130, 21)])
def test_plain_syrk_matches_exact_einsum(naux, neo):
    """syrk_df_plain and eri_from_df (CPU tensor) vs the f64 einsum;
    tolerance 1e-12 relative."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    L = _factors(naux, neo, seed=naux)
    eri_ref = np.einsum("xij, xkl -> ijkl", L, L, optimize=True)
    Lt = torch.as_tensor(L)
    F = ek.pack_tril(Lt)
    ti, tj = np.tril_indices(neo)
    Fref = L[:, ti, tj]
    assert _rel(ek.syrk_df_plain(F).numpy(), Fref.T @ Fref) < 1e-12
    before = ek.syrk_df.launches
    eri = ek.eri_from_df(Lt).numpy()
    assert ek.syrk_df.launches == before      # a CPU tensor runs the plain version
    assert _rel(eri, eri_ref) < 1e-12


def test_pack_unpack_match_jax():
    """s4 pack order is np.tril_indices row order, as in the JAX package."""
    from libdmet_preview_tpu.ops import pallas_eri
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    L = _factors(7, 6, seed=1)
    F_t = ek.pack_tril(torch.as_tensor(L)).numpy()
    np.testing.assert_array_equal(F_t, pallas_eri.pack_tril(L))
    S = F_t.T @ F_t
    np.testing.assert_array_equal(
        ek.unpack_s4(torch.as_tensor(S), 6).numpy(),
        pallas_eri.unpack_s4(S, 6))


def test_matches_pallas_kernel_interpret():
    """The port at (naux, neo) = (256, 28) vs the Pallas split-fp32 kernel
    in interpret mode; tolerance 1e-6, that kernel's own bound."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from libdmet_preview_tpu.ops.pallas_eri import eri_from_df_pallas
    from libdmet_preview_tpu_torch.ops.eri_kernels import eri_from_df
    L = _factors(256, 28, seed=5, scale=0.1)
    eri_pl = eri_from_df_pallas(L, interpret=True)
    eri_t = eri_from_df(torch.as_tensor(L)).numpy()
    assert _rel(eri_t, eri_pl) < 1e-6
    e2 = eri_t.reshape(28 * 28, 28 * 28)
    assert np.abs(e2 - e2.T).max() == 0.0


def test_plain_cross_matches_exact_einsum():
    """syrk_df_plain(F, F2) and eri_from_df(La, Lb) (CPU tensors) vs the
    f64 einsum at (naux, neo) = (96, 18); tolerance 1e-12 relative.  The
    two factors differ, so the ab block is not symmetric."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    La = _factors(96, 18, seed=3)
    Lb = _factors(96, 18, seed=4)
    ti, tj = np.tril_indices(18)
    Fa, Fb = La[:, ti, tj], Lb[:, ti, tj]
    out = ek.syrk_df_plain(torch.as_tensor(Fa), torch.as_tensor(Fb)).numpy()
    assert _rel(out, Fa.T @ Fb) < 1e-12
    assert np.abs(out - out.T).max() > 1e-3
    before = (ek.syrk_df.launches, ek.syrk_df.cross_launches)
    eri = ek.eri_from_df(torch.as_tensor(La), torch.as_tensor(Lb)).numpy()
    assert (ek.syrk_df.launches, ek.syrk_df.cross_launches) == before
    eri_ref = np.einsum("xij, xkl -> ijkl", La, Lb, optimize=True)
    assert _rel(eri, eri_ref) < 1e-12


def test_cross_matches_pallas_kernel_interpret():
    """The port's cross block at (96, 18) vs the Pallas split-fp32
    _syrk_kernel in interpret mode; tolerance 1e-6, that kernel's own
    bound (tests/test_pallas_eri.py::test_cross_gemm_split_precision)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from libdmet_preview_tpu.ops.pallas_eri import eri_from_df_pallas
    from libdmet_preview_tpu_torch.ops.eri_kernels import eri_from_df
    rng = np.random.RandomState(3)
    La = rng.randn(96, 18, 18)
    La = 0.5 * (La + La.transpose(0, 2, 1)) * 0.3
    Lb = rng.randn(96, 18, 18)
    Lb = 0.5 * (Lb + Lb.transpose(0, 2, 1)) * 0.3
    eri_pl = eri_from_df_pallas(La, Lb, interpret=True)
    eri_t = eri_from_df(torch.as_tensor(La), torch.as_tensor(Lb)).numpy()
    assert _rel(eri_t, eri_pl) < 1e-6


def test_cross_shape_mismatch_raises():
    """F and F2 of different shapes are refused before any launch."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    F = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        ek.syrk_df(F, torch.zeros((4, 6), dtype=torch.float64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("naux, neo", [(512, 32), (300, 45), (7, 2)])
def test_cuda_kernel_matches_plain(cuda_device, naux, neo):
    """The CUDA syrk vs F^T F on the card: 1e-12 relative, exactly
    symmetric, and counted as one launch."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    L = torch.as_tensor(_factors(naux, neo, seed=neo), device=cuda_device)
    F = ek.pack_tril(L)
    before = ek.syrk_df.launches
    out = ek.syrk_df(F)
    torch.cuda.synchronize()
    assert ek.syrk_df.launches == before + 1
    ref = ek.syrk_df_plain(F)
    rel = (torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref))).item()
    assert rel < 1e-12
    assert torch.equal(out, out.T)


@pytest.mark.cuda
@pytest.mark.parametrize("naux, neo", [(96, 18), (300, 45), (7, 2)])
def test_cuda_cross_kernel_matches_plain(cuda_device, naux, neo):
    """The CUDA cross syrk vs F^T F2 on the card: 1e-12 relative, counted
    as one cross launch (and no symmetric one)."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    F = ek.pack_tril(torch.as_tensor(_factors(naux, neo, seed=neo),
                                     device=cuda_device))
    F2 = ek.pack_tril(torch.as_tensor(_factors(naux, neo, seed=neo + 7),
                                      device=cuda_device))
    before = (ek.syrk_df.launches, ek.syrk_df.cross_launches)
    out = ek.syrk_df(F, F2)
    torch.cuda.synchronize()
    assert (ek.syrk_df.launches, ek.syrk_df.cross_launches) == \
        (before[0], before[1] + 1)
    ref = ek.syrk_df_plain(F, F2)
    rel = (torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref))).item()
    assert rel < 1e-12
