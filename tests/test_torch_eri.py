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


SCHEDULE_SHAPES = [(7, 2), (300, 45), (512, 32), (2400, 60), (1024, 96)]


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("naux, neo", SCHEDULE_SHAPES)
def test_syrk_schedule_covers(naux, neo, symmetric):
    """syrk_schedule's blocks (syrk_units, the kernel's own decoding of
    blockIdx.x) cover every output tile once (the lower triangle for tri,
    the square for cross), every aux row once in each tile, and the
    workspace holds exactly the split pieces; 32 x 32 tiles exactly where
    64 x 64 tiles would fill less than one wave."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    npair = neo * (neo + 1) // 2
    sch = ek.syrk_schedule(naux, npair, symmetric)
    nt64 = -(-npair // 64)
    slots = ek.H100_SMS * ek.RESIDENT[64]
    small = (nt64 * (nt64 + 1) // 2 if symmetric else nt64 ** 2) < slots
    assert (sch.tile_m, sch.tile_n) == ((32, 32) if small else (64, 64))
    nt = -(-npair // sch.tile_m)
    want = {(i, j) for i in range(nt) for j in range(nt)
            if j <= i or not symmetric}
    tiles = ek.syrk_tiles(npair, symmetric, sch.tile_m)
    assert len(tiles) == len(want) and set(tiles) == want
    units = ek.syrk_units(naux, npair, symmetric, sch)
    assert len(units) == sch.n_blocks
    rows = {}
    for i, j, k0, k1 in units:
        assert 0 <= k0 < k1 <= naux
        rows.setdefault((i, j), []).append((k0, k1))
    assert set(rows) == want
    for ranges in rows.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == naux
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    n_split_tiles = sum(len(r) > 1 for r in rows.values())
    assert n_split_tiles == len(tiles) - sch.n_whole
    assert all(len(r) in (1, sch.n_split) for r in rows.values())
    assert sch.workspace_elems == (n_split_tiles * sch.n_split
                                   * sch.tile_m * sch.tile_n)
    if sch.n_split > 1:
        # only the short last wave is split: whole tiles fill full waves
        slots = ek.H100_SMS * ek.RESIDENT[sch.tile_m]
        assert sch.n_whole % slots == 0
        assert 0 < n_split_tiles < slots
        # into the most pieces that fit TAIL_PER_SM on each SM
        fit = ek.TAIL_PER_SM * ek.H100_SMS
        assert n_split_tiles * sch.n_split <= fit
        assert n_split_tiles * (sch.n_split + 1) > fit
    if symmetric:
        # the compressed triangle map is integer-exact, tile by tile
        m = 0
        for i in range(nt):
            for j in range(i + 1):
                assert tiles[m] == (i, j)
                m += 1


def test_tri_ij_matches_jax_and_is_exact():
    """The port's tile map (the CUDA kernel's, mirrored in Python) equals
    the JAX package's _tri_ij for m < 20100 and stays integer-exact near
    the int32 limit of the grid."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.pallas_eri import _tri_ij
    from libdmet_preview_tpu_torch.ops.eri_kernels import tri_ij
    ms = np.arange(0, 20100)
    i, j = (np.asarray(x) for x in _tri_ij(jnp.asarray(ms)))
    assert [tri_ij(int(m)) for m in ms] == list(zip(i.tolist(), j.tolist()))
    for ii in (65535, 65536, 92680):
        for jj in (0, 1, ii // 2, ii - 1, ii):
            assert tri_ij(ii * (ii + 1) // 2 + jj) == (ii, jj)


def test_syrk_schedule_explicit_split():
    """An explicit n_split is honoured on the last wave; one that leaves an
    empty piece is refused."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    sch = ek.syrk_schedule(2400, 1830, False, n_split=4)
    assert (sch.tile_m, sch.n_split, sch.n_whole) == (64, 4, 792)
    assert sch.n_blocks == 792 + 49 * 4
    with pytest.raises(ValueError):
        ek.syrk_schedule(20, 1830, False, n_split=3)   # 2 chunks, 3 pieces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("naux, neo", [(512, 32), (300, 45), (7, 2),
                                       (2400, 60)])
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
@pytest.mark.parametrize("naux, neo", [(96, 18), (300, 45), (7, 2),
                                       (2400, 60)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
def test_cuda_kernel_deterministic(cuda_device, symmetric):
    """Two launches at the ab initio path's shape (2400, 60), whose
    schedule splits the last wave and sums the pieces, give bit-identical
    results; the tri output is exactly symmetric."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    F = ek.pack_tril(torch.as_tensor(_factors(2400, 60, seed=60),
                                     device=cuda_device))
    F2 = None if symmetric else ek.pack_tril(torch.as_tensor(
        _factors(2400, 60, seed=67), device=cuda_device))
    assert ek.syrk_schedule(2400, F.shape[1], symmetric).n_split > 1
    a = ek.syrk_df(F, F2)
    b = ek.syrk_df(F, F2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if symmetric:
        assert torch.equal(a, a.T)


# odd npair (8-byte copies), even npair not a multiple of 16 (16-byte .ca)
# and odd npair whose own schedule splits (2400, 61), each on explicit
# schedules: 64 x 64 tiles split in 3 or as the shape gives, 32 x 32 tiles
# whole or split in 2
@pytest.mark.cuda
@pytest.mark.parametrize("tile, n_split", [(64, 3), (64, None), (32, None),
                                           (32, 2)])
@pytest.mark.parametrize("naux, neo", [(300, 45), (300, 20), (2400, 61)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_cuda_kernel_explicit_schedule(cuda_device, symmetric, naux, neo,
                                       tile, n_split):
    """Both kernels on explicit schedules (tile, split) vs F^T F2 on the
    card: 1e-12 relative, the tri output exactly symmetric."""
    from libdmet_preview_tpu_torch.ops import eri_kernels as ek
    F = ek.pack_tril(torch.as_tensor(_factors(naux, neo, seed=neo),
                                     device=cuda_device))
    F2 = None if symmetric else ek.pack_tril(torch.as_tensor(
        _factors(naux, neo, seed=neo + 7), device=cuda_device))
    sch = ek.syrk_schedule(naux, F.shape[1], symmetric, tile=tile,
                           n_split=n_split)
    out = ek.syrk_df_launch(F, F2, sch)
    torch.cuda.synchronize()
    ref = ek.syrk_df_plain(F, F2)
    rel = (torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref))).item()
    assert rel < 1e-12
    if symmetric:
        assert torch.equal(out, out.T)
