"""
Density-fitting embedding-ERI syrk (PyTorch port of
libdmet_preview_tpu/ops/pallas_eri.py: syrk_df, pack_tril, unpack_s4,
eri_from_df_pallas).

  eri[pq, rs] = sum_x F[x, pq] F2[x, rs],   F = s4 pack of B^T L_x B

F2 = None is the symmetric syrk F^T F (restricted, or the aa / bb blocks);
a distinct F2 is the unrestricted ab cross block.  On CUDA tensors syrk_df
launches the hand-written Hopper kernels of csrc/syrk_df.cu (FP64 tensor
cores), exact in float64, on a schedule (the tile size, which tiles run
whole, how the last wave's tiles are split along the aux axis) that
syrk_schedule picks from the shape; every shape goes to the kernel.
On CPU tensors it runs the plain version syrk_df_plain.  There is no
fallback between the two.
"""

import collections
import ctypes
import math

import numpy as np
import torch

from libdmet_preview_tpu_torch.ops import _build


def syrk_df_plain(F, F2=None):
    """Plain PyTorch version of the syrk: F^T F, or F^T F2."""
    return F.T @ (F if F2 is None else F2)


# the kernels' schedule (csrc/syrk_df.cu): square output tiles of 64 rows,
# or 32 where the 64 grid fills less than one wave; KC aux rows per
# pipeline stage; RESIDENT[tile] blocks per SM (64: 4 stages of 2 x KC x 68
# doubles of shared memory, 69,632 B; 32: registers), as the card's
# occupancy query reports it (chip_smoke.py phase 2); the cross kernel
# walks its tiles in groups of GROUP tile rows
TILES = (32, 64)
KC = 16
RESIDENT = {32: 5, 64: 3}
GROUP = 8
H100_SMS = 132
# split pieces of the last wave per SM: two run faster than three, which
# would fill every slot (chip_smoke.py's split scan)
TAIL_PER_SM = 2

SyrkSchedule = collections.namedtuple(
    "SyrkSchedule",
    "tile_m tile_n n_split n_whole n_blocks workspace_elems")


def _cdiv(a, b):
    return -(-a // b)


def tri_ij(m):
    """Integer-exact inverse of m = i(i+1)/2 + j (0 <= j <= i), as the tri
    kernel computes it: float sqrt seed, integer fix-up."""
    t = int(math.floor((math.sqrt(8.0 * m + 1.0) - 1.0) * 0.5))
    while (t + 1) * (t + 2) // 2 <= m:
        t += 1
    while t * (t + 1) // 2 > m:
        t -= 1
    return t, m - t * (t + 1) // 2


def syrk_tiles(npair, symmetric, tile):
    """(i, j) of each output tile number m, tile (i, j) covering rows
    [tile i, tile (i + 1)) and columns [tile j, tile (j + 1)): the lower
    triangle in compressed order (symmetric), else the square in groups of
    GROUP tile rows, column by column within a group (a copy of
    csrc/syrk_df.cu tile_ij; keep the two in step)."""
    nt = _cdiv(npair, tile)
    if symmetric:
        return [tri_ij(m) for m in range(nt * (nt + 1) // 2)]
    tiles = []
    for first in range(0, nt, GROUP):
        rows = min(GROUP, nt - first)
        tiles += [(first + r % rows, r // rows) for r in range(rows * nt)]
    return tiles


def split_rows(naux, n_split):
    """Aux rows per piece of a split tile (a multiple of KC): piece s covers
    rows [s k, min(naux, (s + 1) k))."""
    return _cdiv(_cdiv(naux, KC), n_split) * KC


def syrk_units(naux, npair, symmetric, schedule):
    """(i, j, k0, k1) of each block of the kernel in launch order: tile
    (i, j) over aux rows [k0, k1), as the kernel decodes blockIdx.x (a copy
    of csrc/syrk_df.cu syrk_kernel's decoding; keep the two in step)."""
    tiles = syrk_tiles(npair, symmetric, schedule.tile_m)
    n_whole, n_split = schedule.n_whole, schedule.n_split
    rows = split_rows(naux, n_split)
    units = [tiles[m] + (0, naux) for m in range(n_whole)]
    for m in range(n_whole, len(tiles)):
        for s in range(n_split):
            units.append(tiles[m] + (s * rows, min(naux, (s + 1) * rows)))
    return units


def n_tiles(npair, symmetric, tile):
    """Output tiles of `tile` rows the kernel runs: the lower triangle
    (symmetric) or the square."""
    nt = _cdiv(npair, tile)
    return nt * (nt + 1) // 2 if symmetric else nt * nt


def syrk_schedule(naux, npair, symmetric, n_sm=H100_SMS, n_split=None,
                  tile=None):
    """Schedule of the kernel for (naux, npair) operands, from shapes only:
    SyrkSchedule(tile_m, tile_n, n_split, n_whole, n_blocks,
    workspace_elems).

    64 x 64 tiles: whole tiles fill full waves of RESIDENT[64] blocks on
    each of n_sm SMs; the n_tail tiles of the short last wave are split
    along the aux axis into the most pieces that fit TAIL_PER_SM on each SM
    (n_tail n_split <= TAIL_PER_SM n_sm, at most one piece per KC-row
    chunk), and the pieces are summed in piece order (n_split = 1: every
    tile whole).  Where 64 x 64 tiles would fill less than one wave, 32 x
    32 tiles run whole instead: four times the blocks, no sum.  The tile
    and n_split follow from the shape unless given."""
    if tile is None:
        small = n_tiles(npair, symmetric, 64) < n_sm * RESIDENT[64]
        tile = 32 if small else 64
        if small and n_split is None:
            n_split = 1
    ntiles = n_tiles(npair, symmetric, tile)
    n_tail = ntiles % (n_sm * RESIDENT[tile])
    chunks = _cdiv(naux, KC)
    if n_split is None:
        n_split = min(max(1, TAIL_PER_SM * n_sm // n_tail), chunks) \
            if n_tail else 1
        # as many pieces as KC-row chunks per piece leave non-empty
        n_split = _cdiv(chunks, _cdiv(chunks, n_split))
    elif _cdiv(naux, split_rows(naux, n_split)) != n_split:
        raise ValueError("syrk_schedule: %d pieces of %d aux rows leave one "
                         "empty" % (n_split, naux))
    if n_tail == 0 or n_split == 1:
        n_tail, n_split = 0, 1
    return SyrkSchedule(tile, tile, n_split, ntiles - n_tail,
                        ntiles - n_tail + n_tail * n_split,
                        n_tail * n_split * tile * tile)


def _check_operand(F, name):
    if F.dtype != torch.float64 or F.dim() != 2:
        raise ValueError("syrk_df: %s must be a 2-D float64 tensor, got %s %s"
                         % (name, F.dtype, tuple(F.shape)))
    if not F.is_contiguous():
        raise ValueError("syrk_df: %s must be contiguous" % name)


def syrk_df(F, F2=None):
    """s4-packed DF-ERI F^T F (F2=None, exactly symmetric) or F^T F2 of
    (naux, npair) float64 operands.

    CPU tensors: syrk_df_plain.  CUDA tensors: the hand kernel on the
    schedule syrk_schedule gives for the shape; it raises on a refused
    launch.  syrk_df.launches counts launches of the symmetric kernel,
    syrk_df.cross_launches those of the cross kernel."""
    if F2 is not None and (F2.device != F.device or F2.shape != F.shape):
        raise ValueError("syrk_df: F %s on %s and F2 %s on %s differ"
                         % (tuple(F.shape), F.device, tuple(F2.shape),
                            F2.device))
    if F.device.type == "cpu":
        return syrk_df_plain(F, F2)
    if F.device.type != "cuda":
        raise ValueError("syrk_df: unsupported device %s" % F.device)
    naux, npair = F.shape
    schedule = syrk_schedule(naux, npair, F2 is None,
                             n_sm=_build.sm_count(F.device))
    return syrk_df_launch(F, F2, schedule)


def syrk_df_launch(F, F2, schedule):
    """Launch the kernel on CUDA operands with an explicit `schedule` (a
    SyrkSchedule); counts the launch in syrk_df.launches /
    syrk_df.cross_launches."""
    _check_operand(F, "F")
    if F2 is not None:
        _check_operand(F2, "F2")
    naux, npair = F.shape
    if naux == 0 or npair == 0 or naux > 2 ** 31 - 1 \
            or schedule.n_blocks > 2 ** 31 - 1:
        raise ValueError("syrk_df: unsupported shape %s" % (tuple(F.shape),))
    out = torch.empty((npair, npair), dtype=F.dtype, device=F.device)
    ws = (torch.empty(schedule.workspace_elems, dtype=F.dtype,
                      device=F.device) if schedule.workspace_elems else None)
    args = (int(naux), int(npair), int(schedule.tile_m), int(schedule.n_whole),
            int(schedule.n_split), int(split_rows(naux, schedule.n_split)))
    with torch.cuda.device(F.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(F.device).cuda_stream)
        ws_ptr = ctypes.c_void_p(None if ws is None else ws.data_ptr())
        if F2 is None:
            fn = _build.load("syrk_df", "syrk_df_tri_f64")
            rc = fn(ctypes.c_void_p(F.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()), ws_ptr, *args, stream)
        else:
            fn = _build.load("syrk_df", "syrk_df_cross_f64")
            rc = fn(ctypes.c_void_p(F.data_ptr()),
                    ctypes.c_void_p(F2.data_ptr()),
                    ctypes.c_void_p(out.data_ptr()), ws_ptr, *args, stream)
    if rc != 0:
        raise RuntimeError("syrk_df kernel launch failed: cudaError %d" % rc)
    if F2 is None:
        syrk_df.launches += 1
    else:
        syrk_df.cross_launches += 1
    return out


syrk_df.launches = 0
syrk_df.cross_launches = 0


# the kernels' copy modes (csrc/syrk_df.cu): 8 bytes through L1, 16 bytes
# L2 only, 16 bytes through L1
COPY_MODES = {0: "8-byte .ca", 1: "16-byte .cg", 2: "16-byte .ca"}


def syrk_df_occupancy(symmetric, copy, tile):
    """(resident blocks per SM, threads per block, dynamic shared memory
    bytes) of the kernel instantiation (symmetric, copy mode, tile), from
    the card's occupancy query."""
    info = (ctypes.c_int * 3)()
    fn = _build.load("syrk_df", "syrk_df_occupancy")
    rc = fn(int(bool(symmetric)), int(copy), int(tile),
            ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError("syrk_df occupancy query failed: cudaError %d"
                           % rc)
    return tuple(info)


def tril_pairs(neo, device):
    """np.tril_indices(neo) row order as two long tensors on `device`."""
    ti, tj = np.tril_indices(neo)
    return (torch.as_tensor(ti, device=device),
            torch.as_tensor(tj, device=device))


def pack_tril(Lemb):
    """(naux, neo, neo) symmetric -> s4-packed (naux, neo*(neo+1)/2)."""
    ti, tj = tril_pairs(Lemb.shape[-1], Lemb.device)
    return Lemb[:, ti, tj]


def unpack_s4(eri_s4, neo, out=None):
    """s4-packed (npair, npair) -> full (neo, neo, neo, neo), written into
    `out` when given.  The s4 matrix need not be symmetric (the ab block):
    rows index the (ij) pair, columns the (kl) pair."""
    ti, tj = tril_pairs(neo, eri_s4.device)
    npair = ti.shape[0]
    M = torch.zeros((neo, neo, npair), dtype=eri_s4.dtype,
                    device=eri_s4.device)
    M[ti, tj] = eri_s4[:npair, :npair]
    M[tj, ti] = eri_s4[:npair, :npair]
    if out is None:
        out = torch.empty((neo, neo, neo, neo), dtype=eri_s4.dtype,
                          device=eri_s4.device)
    out[:, :, ti, tj] = M
    out[:, :, tj, ti] = M
    return out


def eri_from_df(Lemb, Lemb2=None, out=None):
    """Full embedding ERI (neo, neo, neo, neo) from embedded DF factors
    Lemb (naux, neo, neo): pack, syrk_df, unpack.  With Lemb2 the cross
    block eri[ij, kl] = sum_x Lemb[x, ij] Lemb2[x, kl] (the unrestricted
    ab channel)."""
    F2 = None if Lemb2 is None else pack_tril(Lemb2)
    return unpack_s4(syrk_df(pack_tril(Lemb), F2), Lemb.shape[-1], out=out)
