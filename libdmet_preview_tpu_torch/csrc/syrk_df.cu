// Density-fitting syrk for Hopper (sm_90a), exact float64, two entry points:
//
//     syrk_df_tri_f64:    out[pq, rs] = sum_x F[x, pq] F[x, rs]
//     syrk_df_cross_f64:  out[pq, rs] = sum_x F[x, pq] F2[x, rs]
//
// F, F2: (naux, npair) row-major; out: (npair, npair) row-major.  F and F2
// are s4 (np.tril_indices row order) packs of the embedded DF factors
// B_s^T L_x B_s, so `out` is the s4-packed embedding ERI: the symmetric aa
// or bb block (tri), or the unrestricted ab block (cross, not symmetric).
//
// Replaces libdmet_preview_tpu/ops/pallas_eri.py::_syrk_tri_kernel (the
// symmetric launch of syrk_df) and ::_syrk_kernel (its F2 launch).  Those
// kernels split every f64 operand into an fp32 (hi, lo) pair and keep a
// Kahan fp32 accumulator because the TPU matrix unit is fp32; they reach
// ~1e-7 relative.  Hopper has native FP64 FMA, so these kernels compute the
// exact f64 product and need neither.
//
// What bounds them on the card: at ab initio shapes (naux=2400, neo=60 ->
// npair=1830: 8.0 GFLOP per triangle, 16.1 GFLOP for the cross square) they
// are FP64-FMA bound, fed from shared memory; at the bench shape (naux=512,
// neo=32 -> npair=528, ~0.14 GFLOP) the tri kernel is launch bound.  Design:
//   * one block per 64x64 output tile: the tri kernel runs only the LOWER
//     triangle of tiles on a compressed 1-D grid, blockIdx.x = m =
//     i(i+1)/2 + j inverted exactly in integers (float sqrt seed + integer
//     fix-up), as pallas_eri._tri_ij does; the cross kernel runs a plain
//     2-D grid over every (i, j) tile;
//   * the aux axis is a loop inside the block, staged through shared
//     memory in chunks of KC rows: the TPU's sequential K grid axis
//     becomes this loop, so there is no cross-block accumulation, no
//     atomics, and the result is deterministic;
//   * 16x16 threads, each holding a 4x4 register micro-tile (rows ty+16u,
//     columns tx+16v), one explicit fma per term;
//   * ragged edges in both naux and npair are masked inside the kernel
//     (zero-filled loads, guarded stores): no host padding;
//   * tri only: each off-diagonal tile is stored together with its mirror
//     from the same registers, and on a diagonal tile the (r, c) and (c, r)
//     sums are the same fma chain on the same products, so `out` is
//     exactly symmetric.
// Both entry points share one block body, templated on SYM.  FP64 mma.sync
// (DMMA) and TMA staging are later work.
//
// Launch contract: runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int KC = 16;
constexpr int TDIM = 16;               // 16 x 16 threads per block
constexpr int NTHREADS = TDIM * TDIM;
constexpr int MICRO = TILE / TDIM;     // 4 x 4 outputs per thread

__device__ __forceinline__ void tri_ij(long long m, int* i, int* j) {
  long long t = (long long)floor((sqrt(8.0 * (double)m + 1.0) - 1.0) * 0.5);
  // float-precision fix-up (at most one step either way)
  while ((t + 1) * (t + 2) / 2 <= m) ++t;
  while (t * (t + 1) / 2 > m) --t;
  *i = (int)t;
  *j = (int)(m - t * (t + 1) / 2);
}

// SYM: F2 == F, lower-triangle tiles from blockIdx.x, mirrored stores.
// !SYM: tile (blockIdx.y, blockIdx.x), plain stores.
template <bool SYM>
__global__ void __launch_bounds__(NTHREADS)
syrk_kernel(const double* __restrict__ F, const double* __restrict__ F2,
            double* __restrict__ out, int naux, int npair) {
  __shared__ double As[KC][TILE];
  __shared__ double Bs[KC][TILE];

  int ti, tj;
  if (SYM) {
    tri_ij((long long)blockIdx.x, &ti, &tj);
  } else {
    ti = (int)blockIdx.y;
    tj = (int)blockIdx.x;
  }
  const int row0 = ti * TILE;
  const int col0 = tj * TILE;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TDIM + tx;

  double acc[MICRO][MICRO];
#pragma unroll
  for (int u = 0; u < MICRO; ++u)
#pragma unroll
    for (int v = 0; v < MICRO; ++v) acc[u][v] = 0.0;

  for (int k0 = 0; k0 < naux; k0 += KC) {
#pragma unroll
    for (int q = 0; q < (KC * TILE) / NTHREADS; ++q) {
      const int idx = tid + q * NTHREADS;
      const int kk = idx / TILE;
      const int c = idx % TILE;
      const int k = k0 + kk;
      const bool kin = k < naux;
      const int r = row0 + c;
      const int s = col0 + c;
      const size_t base = (size_t)k * (size_t)npair;
      As[kk][c] = (kin && r < npair) ? F[base + r] : 0.0;
      Bs[kk][c] = (kin && s < npair) ? F2[base + s] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      double a[MICRO], b[MICRO];
#pragma unroll
      for (int u = 0; u < MICRO; ++u) a[u] = As[kk][ty + TDIM * u];
#pragma unroll
      for (int v = 0; v < MICRO; ++v) b[v] = Bs[kk][tx + TDIM * v];
#pragma unroll
      for (int u = 0; u < MICRO; ++u)
#pragma unroll
        for (int v = 0; v < MICRO; ++v) acc[u][v] = fma(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  const size_t n = (size_t)npair;
#pragma unroll
  for (int u = 0; u < MICRO; ++u) {
#pragma unroll
    for (int v = 0; v < MICRO; ++v) {
      const int r = row0 + ty + TDIM * u;
      const int c = col0 + tx + TDIM * v;
      if (r >= npair || c >= npair) continue;
      if (!SYM) {
        out[(size_t)r * n + c] = acc[u][v];
      } else if (ti != tj) {
        out[(size_t)r * n + c] = acc[u][v];
        out[(size_t)c * n + r] = acc[u][v];
      } else if (r >= c) {
        out[(size_t)r * n + c] = acc[u][v];
        if (r != c) out[(size_t)c * n + r] = acc[u][v];
      }
    }
  }
}

}  // namespace

extern "C" int syrk_df_tri_f64(const double* F, double* out, int naux,
                               int npair, void* stream) {
  const long long nt = (npair + TILE - 1) / TILE;
  const long long nblocks = nt * (nt + 1) / 2;
  syrk_kernel<true><<<(unsigned)nblocks, dim3(TDIM, TDIM), 0,
                      (cudaStream_t)stream>>>(F, F, out, naux, npair);
  return (int)cudaGetLastError();
}

extern "C" int syrk_df_cross_f64(const double* F, const double* F2,
                                 double* out, int naux, int npair,
                                 void* stream) {
  const unsigned nt = (unsigned)((npair + TILE - 1) / TILE);
  syrk_kernel<false><<<dim3(nt, nt), dim3(TDIM, TDIM), 0,
                       (cudaStream_t)stream>>>(F, F2, out, naux, npair);
  return (int)cudaGetLastError();
}
