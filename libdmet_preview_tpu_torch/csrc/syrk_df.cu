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
// ~1e-7 relative.  Hopper's FP64 tensor cores (DMMA) multiply and add in
// f64, so these kernels compute the exact f64 product and need neither.
//
// What bounds them on the card: FP64 operations.  At the ab initio shape
// (naux=2400, neo=60 -> npair=1830) the cross square is 16.1 GFLOP against
// 0.10 GB of traffic (bound 0.24 ms at 67 TFLOP/s), the triangle half of
// that.  Only the FP64 tensor cores reach that rate (the FP64 FMA pipe has
// half of it), and only through warp-level mma.sync: wgmma has no f64 form.
// Design:
//   * the product runs on DMMA, mma.sync.aligned.m16n8k4.row.col.f64 (the
//     m16n8k8 and m16n8k16 shapes measured slower on this body); A = F^T
//     and B = F2 both come from rows of F, contiguous along the pair axis;
//   * one block of 4 warps per 64 x 64 output tile, 32 x 32 warp tiles, 3
//     blocks resident per SM (the tile, warps, depth and MMA shape that
//     cuBLAS's own DGEMM picks at these shapes); where 64 x 64 tiles would
//     fill less than one wave of the card, 32 x 32 tiles (16 x 16 warp
//     tiles, 5 blocks per SM) run whole instead; the tri kernel runs only
//     the lower triangle of tiles, tile m = i(i+1)/2 + j inverted exactly
//     in integers (float sqrt seed + integer fix-up), as
//     pallas_eri._tri_ij does; the cross kernel walks its square in groups
//     of 8 tile rows, column by column, so the tiles in flight share
//     operand panels in L2;
//   * the aux axis streams through a 4-stage ring of shared-memory slabs
//     of KC = 16 rows of each operand, fed by cp.async, so three chunks are
//     in flight while the tensor cores work on the fourth.  The copy mode
//     is chosen at launch from npair and the pointers: 16 bytes where
//     npair is even and the pointers 16-byte aligned (L2 only when rows
//     are 128-byte aligned, npair % 16 == 0, else through L1), else 8
//     bytes through L1 (npair is odd for many neo, and then rows are not
//     16-byte aligned).  Slab rows are padded to tile + 4 doubles, so a
//     warp's 16-byte fragment loads hit every bank pair once per quarter
//     warp (no conflicts);
//   * the schedule comes from the caller (ops/eri_kernels.syrk_schedule):
//     the first n_whole tiles run whole (full waves of the card); the
//     remaining tiles, the short last wave, are split along the aux axis
//     into n_split ranges of k_per_split rows, about two pieces per SM.
//     The pieces go to a workspace and a second kernel sums each
//     tile's n_split pieces in split order: no atomics, bit-for-bit
//     deterministic;
//   * ragged edges in both naux and npair are masked inside the kernel
//     (zero-filled copies, guarded stores): no host padding;
//   * tri only: an off-diagonal tile is stored together with its mirror
//     from the same registers; on a diagonal tile only r >= c is kept and
//     written to (r, c) and (c, r) from the same register (the split sum
//     does the same), so `out` is exactly symmetric without relying on
//     DMMA's summation order.
//
// Launch contract: runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int CR = 4;                 // C doubles per lane of an m16n8 MMA
constexpr int KC = 16;                // aux rows per pipeline stage
constexpr int STAGES = 4;
constexpr int GROUP = 8;              // cross tiles: tile rows per group
constexpr int THREADS = 128;          // 2 x 2 warps

// output tile BT x BT (64, or 32 for grids under one wave): 2 x 2 warps of
// WT x WT, MT x NT MMAs of m16n8 each
template <int BT> struct Cfg {
  static constexpr int WT = BT / 2;
  static constexpr int MT = WT / 16;
  static constexpr int NT = WT / 8;
  static constexpr int LD = BT + 4;   // slab rows, = 4 (mod 16) doubles
  static constexpr int SLAB = KC * LD;  // one operand, one stage
  static constexpr int SMEM = STAGES * 2 * SLAB * (int)sizeof(double);
  static constexpr int MIN_BLOCKS = BT == 32 ? 5 : 3;
};

// m16n8k4: lane (g = lane / 4, t = lane % 4) holds A[g + 8 i][t] (i = 0,
// 1), B[t][g] and C[g + 8 (i / 2)][2 t + i % 2] (i = 0 .. 3)
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[2],
                                    double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// global -> shared copy modes: 8 bytes through L1 (odd npair: rows are
// not 16-byte aligned), 16 bytes L2 only (rows 128-byte aligned), 16 bytes
// through L1 (rows 16- but not 128-byte aligned: a 64-double slab row
// then spans five 128-byte lines, and L1 serves the line it shares with
// the neighbouring copy; measured faster at npair = 1830, slower at
// npair = 4656)
enum Copy { CA8 = 0, CG16 = 1, CA16 = 2 };

// nbytes = 0 writes zeros
template <int CP>
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int nbytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (CP == CA8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
  else if (CP == CG16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void tri_ij(long long m, int* i, int* j) {
  long long t = (long long)floor((sqrt(8.0 * (double)m + 1.0) - 1.0) * 0.5);
  // float-precision fix-up (at most one step either way)
  while ((t + 1) * (t + 2) / 2 <= m) ++t;
  while (t * (t + 1) / 2 > m) --t;
  *i = (int)t;
  *j = (int)(m - t * (t + 1) / 2);
}

// output tile (i, j) of tile number m: the compressed lower triangle (SYM),
// else the grid of tiles in groups of GROUP tile rows, column by column
// within a group, so that the tiles in flight share few operand panels
// (fewer device-memory reads once the operands outgrow L2).
// ops/eri_kernels.syrk_tiles is the Python copy of this map, and
// eri_kernels.syrk_units that of the blockIdx.x decoding in syrk_kernel;
// the CPU tests hold the schedule through them, so keep them in step.
template <bool SYM, int BT>
__device__ __forceinline__ void tile_ij(long long m, int npair, int* i,
                                        int* j) {
  if (SYM) {
    tri_ij(m, i, j);
    return;
  }
  const int nt = (npair + BT - 1) / BT;
  const long long per_group = (long long)GROUP * nt;
  const int first = (int)(m / per_group) * GROUP;
  const int rows = min(GROUP, nt - first);
  const long long r = m % per_group;
  *i = first + (int)(r % rows);
  *j = (int)(r / rows);
}

__device__ __forceinline__ void store2(double* p, double x, double y,
                                       bool vec, bool ok0, bool ok1) {
  if (vec) {
    if (ok0) *reinterpret_cast<double2*>(p) = make_double2(x, y);
  } else {
    if (ok0) p[0] = x;
    if (ok1) p[1] = y;
  }
}

// Block u < n_whole: tile u over all aux rows, stored to out.  Block u >=
// n_whole: piece s = (u - n_whole) % n_split of tile m = n_whole + (u -
// n_whole) / n_split, aux rows [s k_per_split, (s + 1) k_per_split), stored
// as a 64 x 64 tile to ws[(m - n_whole) n_split + s].
// SYM: F2 == F, lower-triangle tiles, mirrored stores.
// CP: the copy mode; with 16-byte copies (npair even, every pointer 16-byte
// aligned) column pairs (2c, 2c + 1) are also stored as double2.
//
// Warp tile rows and columns are laid out for 16-byte fragment loads: MMA
// tile i of a warp covers rows 16 i + 2 g + h (h: the MMA's row half) and
// n-tile j columns 16 (j / 2) + 2 n' + j % 2, so a lane's two A values
// (h = 0, 1) and two B values (j = 2p, 2p + 1) sit side by side in the
// slab, and its outputs form 2 x 4 blocks (rows 2 g + h, columns 4 t + x).
template <bool SYM, int CP, int BT>
__global__ void __launch_bounds__(THREADS, Cfg<BT>::MIN_BLOCKS)
syrk_kernel(const double* __restrict__ F, const double* __restrict__ F2,
            double* __restrict__ out, double* __restrict__ ws, int naux,
            int npair, int n_whole, int n_split, int k_per_split) {
  using C = Cfg<BT>;
  constexpr int WT = C::WT, MT = C::MT, NT = C::NT, LD = C::LD;
  constexpr int SLAB = C::SLAB;
  extern __shared__ __align__(16) double smem[];

  const long long u = blockIdx.x;
  const bool whole = u < n_whole;
  const long long m = whole ? u : n_whole + (u - n_whole) / n_split;
  const int piece = whole ? 0 : (int)((u - n_whole) % n_split);
  int ti, tj;
  tile_ij<SYM, BT>(m, npair, &ti, &tj);
  const int row0 = ti * BT;
  const int col0 = tj * BT;
  const int kbeg = whole ? 0 : piece * k_per_split;
  const int kend = whole ? naux : min(naux, kbeg + k_per_split);
  const int nchunks = kend > kbeg ? (kend - kbeg + KC - 1) / KC : 0;
  const int tid = threadIdx.x;
  const size_t n = (size_t)npair;

  // copy role: W adjacent doubles at column lc of slab rows lr + RPP p
  constexpr bool VEC = CP != CA8;
  constexpr int W = VEC ? 2 : 1;
  constexpr int RPP = THREADS / (BT / W);
  const int lc = (tid % (BT / W)) * W;
  const int lr = tid / (BT / W);
  const bool okA = row0 + lc < npair;   // VEC: then lc + 1 < npair too
  const bool okB = col0 + lc < npair;
  const double* gA = okA ? F + row0 + lc : F;
  const double* gB = okB ? F2 + col0 + lc : F2;

  auto copy = [&](double* dst, const double* src, int k, bool ok) {
    const bool in = ok && k < kend;
    const double* from = src + (in ? (size_t)k * n : 0);
    cp_async<CP>(dst, from, in ? 8 * W : 0);
  };
  auto load = [&](int stage, int chunk) {
    double* sA = smem + stage * 2 * SLAB;
    double* sB = sA + SLAB;
    const int kbase = kbeg + chunk * KC;
#pragma unroll
    for (int p = 0; p < KC / RPP; ++p) {
      const int kk = lr + RPP * p;
      copy(sA + kk * LD + lc, gA, kbase + kk, okA);
      copy(sB + kk * LD + lc, gB, kbase + kk, okB);
    }
  };

  // compute role: warp (wm, wn) owns a 32 x 32 warp tile
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm0 = (warp / 2) * WT;
  const int wn0 = (warp % 2) * WT;
  const int aoff = t * LD + wm0 + 2 * g;
  const int boff = t * LD + wn0 + 2 * g;

  double acc[MT][NT][CR];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < CR; ++r) acc[i][j][r] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ch + STAGES - 1;
    if (nxt < nchunks) load(nxt % STAGES, nxt);
    cp_async_commit();

    const double* sA = smem + (ch % STAGES) * 2 * SLAB + aoff;
    const double* sB = smem + (ch % STAGES) * 2 * SLAB + SLAB + boff;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      double a[MT][2], b[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const double2 v =
            *reinterpret_cast<const double2*>(sA + kk * LD + 16 * i);
        a[i][0] = v.x;
        a[i][1] = v.y;
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const double2 v =
            *reinterpret_cast<const double2*>(sB + kk * LD + 16 * p);
        b[2 * p] = v.x;
        b[2 * p + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // a lane's 2 x 4 output block per (i, p): v[h][x] at tile row
  // 16 i + 2 g + h, tile column 16 p + 4 t + x
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const int rr = wm0 + 16 * i + 2 * g;
      const int cc = wn0 + 16 * p + 4 * t;
      double v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          v[h][x] = acc[i][2 * p + x % 2][2 * h + x / 2];
      if (!whole) {
        double* tile = ws + ((m - n_whole) * n_split + piece) * (BT * BT);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double* row = tile + (rr + h) * BT + cc;
          *reinterpret_cast<double2*>(row) = make_double2(v[h][0], v[h][1]);
          *reinterpret_cast<double2*>(row + 2) =
              make_double2(v[h][2], v[h][3]);
        }
        continue;
      }
      const int r0 = row0 + rr;
      const int c0 = col0 + cc;
      if (SYM && ti == tj) {
        // diagonal tile: r >= c only, to (r, c) and (c, r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = r0 + h, c = c0 + x;
            if (r >= npair || c > r) continue;
            out[(size_t)r * n + c] = v[h][x];
            if (r != c) out[(size_t)c * n + r] = v[h][x];
          }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r0 + h >= npair) continue;
        double* row = out + (size_t)(r0 + h) * n + c0;
        store2(row, v[h][0], v[h][1], VEC, c0 < npair, c0 + 1 < npair);
        store2(row + 2, v[h][2], v[h][3], VEC, c0 + 2 < npair,
               c0 + 3 < npair);
      }
      if (SYM) {
        // mirror: tile column c0 + x is row c0 + x of out
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (c0 + x >= npair) continue;
          store2(out + (size_t)(c0 + x) * n + r0, v[0][x], v[1][x], VEC,
                 r0 < npair, r0 + 1 < npair);
        }
      }
    }
  }
}

// The split tiles: out = the sum of each tile's n_split pieces of ws, in
// piece order.  SYM: each r >= c sum goes to (r, c) and (c, r) from the
// same register.
template <bool SYM, int BT>
__global__ void __launch_bounds__(256)
split_sum(const double* __restrict__ ws, double* __restrict__ out, int npair,
          int n_whole, int n_tail, int n_split) {
  constexpr int TE = BT * BT;           // doubles per tile
  const size_t n = (size_t)npair;
  const size_t total = (size_t)n_tail * TE;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const long long tt = (long long)(idx / TE);
    const int e = (int)(idx % TE);
    int ti, tj;
    tile_ij<SYM, BT>(n_whole + tt, npair, &ti, &tj);
    const int r = ti * BT + e / BT;
    const int c = tj * BT + e % BT;
    if (r >= npair || c >= npair || (SYM && c > r)) continue;
    const double* piece = ws + (size_t)tt * n_split * TE + e;
    double s = piece[0];
    for (int p = 1; p < n_split; ++p) s += piece[(size_t)p * TE];
    out[(size_t)r * n + c] = s;
    if (SYM && r != c) out[(size_t)c * n + r] = s;
  }
}

// cudaFuncSetAttribute for the dynamic shared memory, once per device
template <bool SYM, int CP, int BT>
cudaError_t prepare() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(syrk_kernel<SYM, CP, BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<BT>::SMEM);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

template <bool SYM, int CP, int BT>
int launch(const double* F, const double* F2, double* out, double* ws,
           int naux, int npair, int n_whole, int n_split, int k_per_split,
           cudaStream_t stream) {
  cudaError_t e = prepare<SYM, CP, BT>();
  if (e != cudaSuccess) return (int)e;
  const long long nt = (npair + BT - 1) / BT;
  const long long n_tail = (SYM ? nt * (nt + 1) / 2 : nt * nt) - n_whole;
  syrk_kernel<SYM, CP, BT><<<(unsigned)(n_whole + n_tail * n_split),
                             THREADS, Cfg<BT>::SMEM, stream>>>(
      F, F2, out, ws, naux, npair, n_whole, n_split, k_per_split);
  if (n_tail > 0) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (n_tail * BT * BT + 255) / 256;
    split_sum<SYM, BT><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(ws, out, npair, n_whole, (int)n_tail,
                                   n_split);
  }
  return (int)cudaGetLastError();
}

template <bool SYM, int BT>
int launch_copy(int copy, const double* F, const double* F2, double* out,
                double* ws, int naux, int npair, int n_whole, int n_split,
                int k_per_split, cudaStream_t st) {
  switch (copy) {
    case CG16:
      return launch<SYM, CG16, BT>(F, F2, out, ws, naux, npair, n_whole,
                                   n_split, k_per_split, st);
    case CA16:
      return launch<SYM, CA16, BT>(F, F2, out, ws, naux, npair, n_whole,
                                   n_split, k_per_split, st);
    default:
      return launch<SYM, CA8, BT>(F, F2, out, ws, naux, npair, n_whole,
                                  n_split, k_per_split, st);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || ((unsigned long long)p & 15ull) == 0;
}

// the copy mode for npair and these pointers
int copy_mode(int npair, const double* F, const double* F2,
              const double* out) {
  if (npair % 2 || !aligned16(F) || !aligned16(F2) || !aligned16(out))
    return CA8;
  return npair % 16 == 0 ? CG16 : CA16;
}

template <bool SYM>
int dispatch(const double* F, const double* F2, double* out, double* ws,
             int naux, int npair, int tile, int n_whole, int n_split,
             int k_per_split, void* stream) {
  if (tile != 32 && tile != 64) return (int)cudaErrorInvalidValue;
  const long long nt = (npair + tile - 1) / tile;
  const long long ntiles = SYM ? nt * (nt + 1) / 2 : nt * nt;
  if (n_whole < 0 || n_whole > ntiles || n_split < 1 || k_per_split < 1 ||
      (n_whole < ntiles && (n_split < 2 || ws == nullptr)) ||
      !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int copy = copy_mode(npair, F, F2, out);
  return tile == 32 ? launch_copy<SYM, 32>(copy, F, F2, out, ws, naux, npair,
                                           n_whole, n_split, k_per_split, st)
                    : launch_copy<SYM, 64>(copy, F, F2, out, ws, naux, npair,
                                           n_whole, n_split, k_per_split, st);
}

template <bool SYM, int CP, int BT>
int occupancy(int* info) {
  cudaError_t e = prepare<SYM, CP, BT>();
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], syrk_kernel<SYM, CP, BT>, THREADS, Cfg<BT>::SMEM);
  info[1] = THREADS;
  info[2] = Cfg<BT>::SMEM;
  return (int)e;
}

template <bool SYM, int BT>
int occupancy_copy(int copy, int* info) {
  switch (copy) {
    case CA8: return occupancy<SYM, CA8, BT>(info);
    case CG16: return occupancy<SYM, CG16, BT>(info);
    case CA16: return occupancy<SYM, CA16, BT>(info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Square tiles of `tile` (32 or 64) rows.  Tiles 0 .. n_whole - 1 run
// whole; each later tile runs as n_split pieces of k_per_split aux rows
// (n_split >= 2), summed through ws: (tiles - n_whole) x n_split x tile x
// tile doubles, unused (may be null) when n_whole is every tile.
extern "C" int syrk_df_tri_f64(const double* F, double* out, double* ws,
                               int naux, int npair, int tile, int n_whole,
                               int n_split, int k_per_split, void* stream) {
  return dispatch<true>(F, F, out, ws, naux, npair, tile, n_whole, n_split,
                        k_per_split, stream);
}

extern "C" int syrk_df_cross_f64(const double* F, const double* F2,
                                 double* out, double* ws, int naux,
                                 int npair, int tile, int n_whole,
                                 int n_split, int k_per_split, void* stream) {
  return dispatch<false>(F, F2, out, ws, naux, npair, tile, n_whole, n_split,
                         k_per_split, stream);
}

// info[0] = resident blocks per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), info[1] = threads per block, info[2] = dynamic shared
// memory per block in bytes, of the kernel for (symmetric, copy mode:
// 0 8-byte .ca, 1 16-byte .cg, 2 16-byte .ca, tile 32 or 64).
extern "C" int syrk_df_occupancy(int symmetric, int copy, int tile,
                                 int* info) {
  if (tile == 32)
    return symmetric ? occupancy_copy<true, 32>(copy, info)
                     : occupancy_copy<false, 32>(copy, info);
  if (tile == 64)
    return symmetric ? occupancy_copy<true, 64>(copy, info)
                     : occupancy_copy<false, 64>(copy, info);
  return (int)cudaErrorInvalidValue;
}
