// FCI sigma for Hopper (sm_90a), exact float64: sigma = H c over the
// determinant space (na alpha strings x nb beta strings), with the
// Knowles-Handy resolution of solvers/fci.py and perfbench/roofline.
// sigma_work:
//
//     g_a   = H_aa D^a + H_ab D^b,      D^s[pq] = E^s_pq c
//     g_b   = H_bb D^b + H_ab^T D^a
//     sigma = sum_pq E^a_pq g_a[pq] + E^b_pq g_b[pq]
//
// It replaces no TPU kernel: the JAX package's sigma
// (libdmet_preview_tpu/solvers/fci.py::_sigma_uhf / _sigma_rhf) is jnp,
// with no Pallas.  It replaces the port's plain version, which wrote D^a,
// D^b, g_a and g_b as dense (norb^2, na, nb) tensors (0.98 GB each at 12
// orbitals, 6 + 6 electrons) and multiplied their zeros.
//
// What bounds it on the card: FP64 operations.  Every non-zero entry of
// D^a and D^b meets a full norb^2 column of each integral block it meets:
// 4.13e10 FLOP at 12 orbitals, 6 + 6 electrons (853,776 determinants),
// 0.616 ms at the 67 TFLOP/s of the FP64 tensor cores, against 13.9 MB
// of c, sigma and integrals (4 us at 3.35 TB/s).  Design:
//   * a block owns one SIDE (alpha: gather and scatter along alpha links,
//     columns are beta strings; beta: the same with the axes swapped),
//     a tile of up to 16 columns, and a range of the side's own strings;
//     its sigma rows (all own strings x the tile's columns) stay in
//     shared memory for the whole block (924 x 16 doubles, 118 KB);
//   * the own strings are walked in BATCHES of up to 8 strings that share
//     no excitation target (no two differ by fewer than three electrons,
//     ops/fci_sigma.string_batches), so the scatters of one batch never
//     meet: no atomics, one barrier a batch, and a fixed order of batches,
//     so two calls agree bit for bit;
//   * the same-spin term: warp w takes string J = batch[w]; the links into
//     J (nlink of them, 4 per k-step) select rows pq of W = H^T, which the
//     block holds in shared memory (a slice of up to 80 of the norb^2
//     columns rs a pass, rows padded so that rows of different bank
//     classes never meet; ops/fci_sigma.link_tables deals each string's
//     links over its k-steps class by class); B = sign * c[I_in, tile
//     columns], gathered from global memory (c stays in L2); D^a is never
//     written out.  The product runs on DMMA,
//     mma.sync.aligned.m16n8k4.row.col.f64 (wgmma has no f64 form), M =
//     rs, N = the tile's columns, K = J's links;
//   * the cross term: warp w takes tile column w, then w + 8, whose links
//     (of the other spin, staged once a block) select the rows of W =
//     H_ab^T (alpha side) or H_ab (beta side); N = the strings of two
//     batches, K = the column's links;
//   * latency: the link words and target rows of a step are staged two
//     steps ahead (cp.async, a ring of three buffers), and half of a
//     step's B values are loaded a step ahead into registers;
//   * the second link application accumulates in shared memory: a
//     product's row rs for string J adds into sigma row K of the outgoing
//     link E_rs |J> = +-|K> (the staged table out[J][rs]); all norb^2 rows
//     are computed, as sigma_work counts, and the rows with no link drop.
//     The rows rs sit in the order ops/fci_sigma.row_positions gives: the
//     norb diagonal rows E_pp, which all add into the string's own row,
//     are the rows that MMA lane g = 0 holds, so one lane adds them in
//     turn;
//   * restricted integrals pass one block for all three; GHF (nb = 1, no
//     beta links) runs the alpha side's same-spin term alone;
//   * the launch: one copy kernel lays c out in the batch orders
//     (c[:, perm_b] and c^T[:, perm_a], zero at padded positions), the
//     main kernel writes each (side, split) piece of sigma to a workspace,
//     and a last kernel sums the pieces in a fixed order: three launches a
//     build, nothing of size norb^2 na nb anywhere;
//   * the plan (tile, m-tiles a pass, split of the string range, shared
//     memory) comes from the caller, ops/fci_sigma.sigma_plan, which also
//     holds the Python mirror of this schedule that the CPU tests run.
//
// Measured on one H100 (700 W) at 12 orbitals, 6 + 6: 3.7 ms a build, 17%
// of the bound, 2.7x the plain version.  What holds it there: one block
// of 8 warps per SM in step with a barrier a batch; the B gathers, 1.9 GB
// of 64- and 128-byte pieces from L2 a build (0.8 ms of it); the adds
// into the sigma rows (0.5 ms).
//
// Launch contract: runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int JB = 8;         // strings per batch at most
constexpr int CT = 16;        // columns per tile at most
constexpr int MT_MAX = 5;     // m-tiles (16 rows rs) per pass at most
constexpr int WPAD = 4;       // W slice rows padded to 16 mt + 4 doubles

// one side's arguments (ops/fci_sigma.py packs them in this order)
struct Side {
  const double* X;       // (n_own, npad_oth): own strings x other positions
  const double* Y;       // (n_oth, npad_own): other strings x own positions
  const double* Wsame;   // (nn, nnp): W[pq][pos(rs)] = H[rs][pq], zero pads
  const double* Wcross;  // (nn, nnp)
  const int* lin_own;    // (n_own, 4 nk_own) packed incoming links
  const int* lin_oth;    // (n_oth, 4 nk_oth)
  const short* out_own;  // (n_own, nnp8): (K + 1) * sign of E_rs|J> at
                         // pos(rs), or 0
  const int* perm_own;   // (npad_own): position -> string, -1 padding
  const int* perm_oth;   // (npad_oth)
  double* piece;         // this side's first piece of the workspace
  long long so, sp;      // piece strides of (own string, other string)
  int n_own, npad_own, npad_oth, bs_own, nbatch_own, nk_own, nk_oth;
  int cs;                // tile width: sigma row length in shared memory
  int ntile, bps, blocks, same, cross;
};

struct Common {
  int nn, nnp8, nnp, mt, npass, stage_bytes, sig_doubles;
  long long piece_elems;
};

// m16n8k4: lane (g = lane / 4, t = lane % 4) holds A[g + 8 i][t] (i = 0,
// 1), B[t][g] and C[g + 8 (i / 2)][2 t + i % 2] (i = 0 .. 3)
__device__ __forceinline__ void mma(double (&c)[4], double a0, double a1,
                                    double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// 16 bytes global -> shared; nbytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int nbytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// packed link word (ops/fci_sigma.link_tables): bit 0 valid, bit 1
// negative sign, bits 2-10 the integral row in the W slice, bits 11-31
// the source string
__device__ __forceinline__ bool lw_valid(int w) { return w & 1; }
__device__ __forceinline__ double lw_sign(int w) {
  return (w & 2) ? -1.0 : 1.0;
}
__device__ __forceinline__ int lw_row(int w) { return (w >> 2) & 511; }
__device__ __forceinline__ int lw_src(int w) {
  return (int)((unsigned)w >> 11);
}

// The string of slot `slot` of own batch bb, or -1 (padding, or past the
// block's range).
__device__ __forceinline__ int slot_string(const Side& S, int bb, int b1,
                                           int slot) {
  if (slot >= S.bs_own || bb >= b1) return -1;
  return S.perm_own[(size_t)S.bs_own * bb + slot];
}

// What one warp multiplies in one step: the link words of its string (K =
// the links, 4 a k-step, lane t reading word 4 k + t), the rows they
// select of `base` (X or Y, row stride `stride`) and, per n-tile j, the
// column off[j] (+ g, the lane's column) or nothing (ok[j] false).
struct Feed {
  const int* words;
  const double* base;
  int stride;
  int off[2];
  bool ok[2];
  bool live;
};

// This lane's B values of k-step k: sign * base[src][off[j]]
__device__ __forceinline__ void load_b(const Feed& f, int k, int t,
                                       double& b0, double& b1) {
  b0 = b1 = 0.0;
  const int w = f.words[4 * k + t];
  if (!lw_valid(w)) return;
  const double* r = f.base + (size_t)lw_src(w) * f.stride;
  const double sg = lw_sign(w);
  if (f.ok[0]) b0 = sg * r[f.off[0]];
  if (f.ok[1]) b1 = sg * r[f.off[1]];
}

// One warp's product of a step: acc[i][j] (m-tile i of the pass, n-tile
// j) = sum over the NKM k-steps of W rows (the words' integral rows,
// shared memory) times B (lo: k-steps below KP, hi: the rest).  MTP
// m-tiles and NT n-tiles are template parameters, so the loads and MMAs of
// a k-step form one block of straight-line code.
template <int NKM, int MTP, int NT>
__device__ __forceinline__ void mma_step(double (&acc)[MT_MAX][2][4],
                                         const double (&lo)[NKM / 2][2],
                                         const double (&hi)[NKM - NKM / 2][2],
                                         const int* words, const double* W,
                                         int ldw, int t, int g) {
  constexpr int KP = NKM / 2;
#pragma unroll
  for (int i = 0; i < MTP; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;
#pragma unroll
  for (int k = 0; k < NKM; ++k) {
    const double b0 = k < KP ? lo[k][0] : hi[k - KP][0];
    const double b1 = k < KP ? lo[k][1] : hi[k - KP][1];
    const double* arow = W + (size_t)lw_row(words[4 * k + t]) * ldw + 2 * g;
    double2 a[MTP];
#pragma unroll
    for (int i = 0; i < MTP; ++i)
      a[i] = *reinterpret_cast<const double2*>(arow + 16 * i);
#pragma unroll
    for (int i = 0; i < MTP; ++i) {
      mma(acc[i][0], a[i].x, a[i].y, b0);
      if (NT == 2) mma(acc[i][1], a[i].x, a[i].y, b1);
    }
  }
}

// Block u < sa.blocks: side a, else side b.  Within a side: tile u %
// ntile, split u / ntile (own batches [split bps, (split + 1) bps)).
//
// A pass walks STEPS, one barrier each; in a step every warp multiplies
// one string's links (same-spin: string slot `warp` of batch b0 + s, N =
// the tile's columns) or one column's links (cross: column 8 (s / nsc) +
// warp, N = the strings of batches b0 + 2 (s % nsc) + {0, 1}), then adds
// the product into the sigma rows.  The link words and target rows of a
// step are staged in shared memory two steps ahead (a ring of three
// buffers); the B values of k-steps below KP are loaded one step ahead
// into registers, the rest at the step's start, behind the first KP
// k-steps' MMAs.
template <int NKM>
__global__ void __launch_bounds__(THREADS, 1)
sigma_kernel(const __grid_constant__ Side sa, const __grid_constant__ Side sb,
             const __grid_constant__ Common cm) {
  constexpr int KP = NKM / 2;
  constexpr int KH = NKM - KP;
  extern __shared__ __align__(16) double smem[];
  const bool first = (int)blockIdx.x < sa.blocks;
  const Side& S = first ? sa : sb;
  const int u = first ? (int)blockIdx.x : (int)blockIdx.x - sa.blocks;
  const int tile = u % S.ntile;
  const int split = u / S.ntile;
  const int b0 = split * S.bps;
  const int b1 = min(S.nbatch_own, b0 + S.bps);
  const int cs = S.cs;
  const int c0 = tile * cs;
  const int ncol = min(cs, S.npad_oth - c0);
  const int ntc = (cs + 7) / 8;  // column n-tiles of the same-spin term
  const int nrow = cm.nn, nnp8 = cm.nnp8;
  const int ldw = 16 * cm.mt + WPAD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  double* sig = smem;                       // n_own x cs
  double* W = smem + cm.sig_doubles;        // nrow x ldw
  char* stage = reinterpret_cast<char*>(W + (size_t)nrow * ldw);
  // the link words of the tile's columns (cross term), CT x 4 nk_oth,
  // zero (padding words) past the tile's columns
  int* cwords = reinterpret_cast<int*>(stage + 3 * (size_t)cm.stage_bytes);
  for (int i = tid; i < S.n_own * cs; i += THREADS) sig[i] = 0.0;
  if (S.cross) {
    for (int q = tid; q < CT * S.nk_oth; q += THREADS) {
      const int col = q / S.nk_oth;
      const int r = q % S.nk_oth;
      const int o = col < ncol ? S.perm_oth[c0 + col] : -1;
      cp_async16(cwords + col * 4 * S.nk_oth + 4 * r,
                 S.lin_oth + (size_t)(o < 0 ? 0 : o) * 4 * S.nk_oth + 4 * r,
                 o < 0 ? 0 : 16);
    }
  }

  for (int phase = 0; phase < 2; ++phase) {
    const bool same = phase == 0;
    if (same ? !S.same : !S.cross) continue;
    const double* Wg = same ? S.Wsame : S.Wcross;
    const int nsc = b1 > b0 ? (b1 - b0 + 1) / 2 : 0;  // cross steps a half
    const int nsteps = same ? max(0, b1 - b0) : ((ncol + 7) / 8) * nsc;
    const int idx_bytes = JB * 16 * S.nk_own;

    // stage step s into buffer buf: the same-spin term stages its 8
    // strings' incoming links and target rows, the cross term the target
    // rows of its 16 strings
    // a stage is 16-byte chunks: the same-spin term stages its 8 strings'
    // incoming links and target rows, the cross term the target rows of
    // its 16 strings.  chunk_string(s, q): the string whose rows chunk q of
    // step s copies (a global read, made a step before the copy is issued)
    const int cho = nnp8 / 8;               // 16-byte chunks a target row
    const int chi = same ? S.nk_own : 0;    // 16-byte chunks a link row
    const int nchunk = same ? JB * (chi + cho) : 2 * JB * cho;
    auto chunk_string = [&](int s, int q) {
      if (q >= nchunk || s >= nsteps) return -1;
      if (same) return slot_string(S, b0 + s, b1, q / (chi + cho));
      const int w = q / cho;
      return slot_string(S, b0 + 2 * (s % nsc) + w / JB, b1, w % JB);
    };
    auto stage_step = [&](char* buf, const int (&js)[2]) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = tid + e * THREADS;
        if (q >= nchunk) continue;
        const int J = js[e];
        if (same) {
          const int w = q / (chi + cho);
          int r = q % (chi + cho);
          if (r < chi) {
            int* dst = reinterpret_cast<int*>(buf) + w * 4 * S.nk_own + 4 * r;
            const int* src = S.lin_own + (size_t)(J < 0 ? 0 : J) * 4 * S.nk_own
                             + 4 * r;
            cp_async16(dst, src, J < 0 ? 0 : 16);
          } else {
            r -= chi;
            short* dst = reinterpret_cast<short*>(buf + idx_bytes)
                         + w * nnp8 + 8 * r;
            const short* src = S.out_own + (size_t)(J < 0 ? 0 : J) * nnp8
                               + 8 * r;
            cp_async16(dst, src, J < 0 ? 0 : 16);
          }
        } else {
          const int w = q / cho;
          const int r = q % cho;
          short* dst = reinterpret_cast<short*>(buf) + w * nnp8 + 8 * r;
          const short* src = S.out_own + (size_t)(J < 0 ? 0 : J) * nnp8
                             + 8 * r;
          cp_async16(dst, src, J < 0 ? 0 : 16);
        }
      }
    };
    auto strings_of = [&](int s, int (&js)[2]) {
      js[0] = chunk_string(s, tid);
      js[1] = chunk_string(s, tid + THREADS);
    };
    auto buffer = [&](int s) {
      return stage + (size_t)(s % 3) * cm.stage_bytes;
    };
    // this warp's work in step s
    auto feed = [&](int s) {
      Feed f;
      if (same) {
        f.words =
            reinterpret_cast<const int*>(buffer(s)) + warp * 4 * S.nk_own;
        f.live = lw_valid(f.words[0]);
        f.base = S.X;
        f.stride = S.npad_oth;
        for (int j = 0; j < 2; ++j) {
          f.off[j] = c0 + 8 * j + g;
          f.ok[j] = j < ntc && 8 * j + g < ncol;
        }
      } else {
        const int cc = 8 * (s / nsc) + warp;
        f.words = cwords + cc * 4 * S.nk_oth;
        f.live = cc < ncol && lw_valid(f.words[0]);
        f.base = S.Y;
        f.stride = S.npad_own;
        const int bb0 = b0 + 2 * (s % nsc);
        for (int j = 0; j < 2; ++j) {
          f.off[j] = S.bs_own * (bb0 + j) + g;
          f.ok[j] = bb0 + j < b1 && g < S.bs_own;
        }
      }
      return f;
    };

    for (int pass = 0; pass < cm.npass; ++pass) {
      const int r0 = pass * 16 * cm.mt;
      const int mtp = min(cm.mt, (cm.nnp - r0) / 16);
      __syncthreads();                      // W and the stage buffers free
      {
        const int half = 8 * cm.mt;         // 16-byte chunks a W row
        for (int q = tid; q < nrow * half; q += THREADS) {
          const int row = q / half;
          const int col = r0 + 2 * (q % half);
          const bool in = col < cm.nnp;
          cp_async16(W + (size_t)row * ldw + 2 * (q % half),
                     Wg + (size_t)row * cm.nnp + (in ? col : 0), in ? 16 : 0);
        }
      }
      int js[2];
      strings_of(0, js);
      stage_step(buffer(0), js);
      strings_of(1, js);
      stage_step(buffer(1), js);
      strings_of(2, js);
      cp_async_commit();

      double lo[KP][2];
      for (int s = 0; s < nsteps; ++s) {
        cp_async_wait_all();
        __syncthreads();                    // steps s, s + 1 staged
        if (s + 2 < nsteps) stage_step(buffer(s + 2), js);
        strings_of(s + 3, js);
        cp_async_commit();

        // a warp with no string or column this step multiplies zeros: its
        // words are padding (B = 0), and the MMAs stay out of branches
        // that depend on data
        const Feed fc = feed(s);
        double hi[KH][2];
        double nx[KP][2];
#pragma unroll
        for (int k = 0; k < KP; ++k)
          if (s == 0) load_b(fc, k, t, lo[k][0], lo[k][1]);
#pragma unroll
        for (int k = 0; k < KH; ++k)
          load_b(fc, KP + k, t, hi[k][0], hi[k][1]);
        if (s + 1 < nsteps) {
          const Feed fn = feed(s + 1);
#pragma unroll
          for (int k = 0; k < KP; ++k)
            load_b(fn, k, t, nx[k][0], nx[k][1]);
        }
        double acc[MT_MAX][2][4];
        const bool two = !same || ntc > 1;
        switch (2 * mtp + (two ? 1 : 0)) {
#define FCI_SIGMA_CASE(M)                                                  \
          case 2 * M:                                                      \
            mma_step<NKM, M, 1>(acc, lo, hi, fc.words, W, ldw, t, g);    \
            break;                                                         \
          case 2 * M + 1:                                                  \
            mma_step<NKM, M, 2>(acc, lo, hi, fc.words, W, ldw, t, g);    \
            break;
          FCI_SIGMA_CASE(1)
          FCI_SIGMA_CASE(2)
          FCI_SIGMA_CASE(3)
          FCI_SIGMA_CASE(4)
          FCI_SIGMA_CASE(5)
#undef FCI_SIGMA_CASE
        }
        if (fc.live) {
          // MMA row g of m-tile i is product row r0 + 16 i + 2 g, row
          // g + 8 the next one
          const char* cur = buffer(s);
          if (same) {
            const short* sout = reinterpret_cast<const short*>(cur + idx_bytes)
                                + warp * nnp8;
#pragma unroll
            for (int i = 0; i < MT_MAX; ++i) {
              if (i >= mtp) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int v = sout[r0 + 16 * i + 2 * g + h];
                if (v == 0) continue;
                double* srow = sig + (size_t)((v > 0 ? v : -v) - 1) * cs;
                const double sg = v > 0 ? 1.0 : -1.0;
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                  for (int x = 0; x < 2; ++x) {
                    const int n = 8 * j + 2 * t + x;
                    if (j < ntc && n < ncol)
                      srow[n] += sg * acc[i][j][2 * h + x];
                  }
              }
            }
          } else {
            const int cc = 8 * (s / nsc) + warp;
            const int bb0 = b0 + 2 * (s % nsc);
            const short* sout = reinterpret_cast<const short*>(cur);
            // the two batches' strings may share targets: one batch at a
            // time, the warp in step between them
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (bb0 + j < b1) {
#pragma unroll
                for (int i = 0; i < MT_MAX; ++i) {
                  if (i >= mtp) continue;
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int rs = r0 + 16 * i + 2 * g + h;
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                      const int v = sout[(JB * j + 2 * t + x) * nnp8 + rs];
                      if (v == 0) continue;
                      const double sg = v > 0 ? 1.0 : -1.0;
                      sig[(size_t)((v > 0 ? v : -v) - 1) * cs + cc] +=
                          sg * acc[i][j][2 * h + x];
                    }
                  }
                }
              }
              __syncwarp();
            }
          }
        }
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          lo[k][0] = nx[k][0];
          lo[k][1] = nx[k][1];
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  double* piece = S.piece + (size_t)split * cm.piece_elems;
  for (int q = tid; q < S.n_own * ncol; q += THREADS) {
    const int K = q / ncol;
    const int n = q % ncol;
    const int p = S.perm_oth[c0 + n];
    if (p >= 0) piece[K * S.so + p * S.sp] = sig[(size_t)K * cs + n];
  }
}

// A (na x npad_b) = c[:, perm_b], B (nb x npad_a) = c^T[:, perm_a], zero
// at padded positions
__global__ void __launch_bounds__(256)
layout_kernel(const double* __restrict__ c, double* __restrict__ A,
              double* __restrict__ B, int na, int nb,
              const int* __restrict__ perm_a, int npad_a,
              const int* __restrict__ perm_b, int npad_b) {
  const long long nA = (long long)na * npad_b;
  const long long nall = nA + (long long)nb * npad_a;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < nall; q += (long long)gridDim.x * blockDim.x) {
    if (q < nA) {
      const int i = (int)(q / npad_b);
      const int p = perm_b[q % npad_b];
      A[q] = p < 0 ? 0.0 : c[(size_t)i * nb + p];
    } else {
      const long long r = q - nA;
      const int i = (int)(r / npad_a);
      const int p = perm_a[r % npad_a];
      B[r] = p < 0 ? 0.0 : c[(size_t)p * nb + i];
    }
  }
}

// out = the sum of the npieces pieces of ws, in piece order
__global__ void __launch_bounds__(256)
sum_pieces(const double* __restrict__ ws, double* __restrict__ out,
           long long n, int npieces) {
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < n; q += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int p = 0; p < npieces; ++p) s += ws[(size_t)p * n + q];
    out[q] = s;
  }
}

// cudaFuncSetAttribute for the dynamic shared memory, once per device
template <int NKM>
cudaError_t prepare(int smem) {
  static unsigned long long done = 0;
  static int done_smem[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (done >> dev & 1ull) && done_smem[dev] >= smem)
    return cudaSuccess;
  e = cudaFuncSetAttribute(sigma_kernel<NKM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 64) {
    done |= 1ull << dev;
    done_smem[dev] = smem;
  }
  return e;
}

Side unpack(const long long* w) {
  Side s;
  s.X = reinterpret_cast<const double*>(w[0]);
  s.Y = reinterpret_cast<const double*>(w[1]);
  s.Wsame = reinterpret_cast<const double*>(w[2]);
  s.Wcross = reinterpret_cast<const double*>(w[3]);
  s.lin_own = reinterpret_cast<const int*>(w[4]);
  s.lin_oth = reinterpret_cast<const int*>(w[5]);
  s.out_own = reinterpret_cast<const short*>(w[6]);
  s.perm_own = reinterpret_cast<const int*>(w[7]);
  s.perm_oth = reinterpret_cast<const int*>(w[8]);
  s.piece = reinterpret_cast<double*>(w[9]);
  s.so = w[10];
  s.sp = w[11];
  s.n_own = (int)w[12];
  s.npad_own = (int)w[13];
  s.npad_oth = (int)w[14];
  s.bs_own = (int)w[15];
  s.nbatch_own = (int)w[16];
  s.nk_own = (int)w[17];
  s.nk_oth = (int)w[18];
  s.cs = (int)w[19];
  s.ntile = (int)w[20];
  s.bps = (int)w[21];
  s.blocks = (int)w[22];
  s.same = (int)w[23];
  s.cross = (int)w[24];
  return s;
}

template <int NKM>
int launch_main(const Side& a, const Side& b, const Common& cm, int smem,
                cudaStream_t st) {
  cudaError_t e = prepare<NKM>(smem);
  if (e != cudaSuccess) return (int)e;
  sigma_kernel<NKM><<<a.blocks + b.blocks, THREADS, smem, st>>>(a, b, cm);
  return (int)cudaGetLastError();
}

int blocks_for(long long n) {
  const long long b = (n + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// One sigma build: three launches on `stream`.
//   c (na x nb), out (na x nb), ws (npieces x na x nb), A (na x npad_b),
//   B (nb x npad_a): float64, contiguous;
//   side_a, side_b: 30 int64 words each (ops/fci_sigma.py), with
//   X / Y / piece left for this function to fill from A, B, ws;
//   common: nn, nnp8, nnp, mt, npass, stage_bytes, sig_doubles, nkm,
//   smem, npieces, piece offset of side b (in pieces).
extern "C" int fci_sigma_f64(const double* c, double* out, double* ws,
                             double* A, double* B, const long long* side_a,
                             const long long* side_b,
                             const long long* common, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Side a = unpack(side_a);
  Side b = unpack(side_b);
  const int na = a.n_own, nb = b.n_own;
  Common cm;
  cm.nn = (int)common[0];
  cm.nnp8 = (int)common[1];
  cm.nnp = (int)common[2];
  cm.mt = (int)common[3];
  cm.npass = (int)common[4];
  cm.stage_bytes = (int)common[5];
  cm.sig_doubles = (int)common[6];
  const int nkm = (int)common[7];
  const int smem = (int)common[8];
  const int npieces = (int)common[9];
  const long long piece_b = common[10];
  cm.piece_elems = (long long)na * nb;
  if (cm.mt < 1 || cm.mt > MT_MAX || cm.nn > 512 || a.cs > 16 ||
      b.cs > 16 || (a.blocks + b.blocks > 0 && smem > 232448))
    return (int)cudaErrorInvalidValue;
  a.X = A;
  a.Y = B;
  b.X = B;
  b.Y = A;
  a.piece = ws;
  b.piece = ws + piece_b * cm.piece_elems;
  layout_kernel<<<blocks_for((long long)na * a.npad_oth +
                             (long long)nb * a.npad_own),
                  256, 0, st>>>(c, A, B, na, nb, a.perm_own, a.npad_own,
                                a.perm_oth, a.npad_oth);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a.blocks + b.blocks > 0) {
    int rc;
    switch (nkm) {
      case 3: rc = launch_main<3>(a, b, cm, smem, st); break;
      case 5: rc = launch_main<5>(a, b, cm, smem, st); break;
      case 8: rc = launch_main<8>(a, b, cm, smem, st); break;
      case 11: rc = launch_main<11>(a, b, cm, smem, st); break;
      case 18: rc = launch_main<18>(a, b, cm, smem, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  sum_pieces<<<blocks_for(cm.piece_elems), 256, 0, st>>>(
      ws, out, cm.piece_elems, npieces);
  return (int)cudaGetLastError();
}

namespace {

template <int NKM>
cudaError_t occupancy(int smem, int* info) {
  cudaError_t e = prepare<NKM>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[0], sigma_kernel<NKM>, THREADS, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, sigma_kernel<NKM>);
  if (e == cudaSuccess) {
    info[1] = THREADS;
    info[2] = attr.numRegs;
  }
  return e;
}

}  // namespace

// info[0] = resident blocks per SM, info[1] = threads per block, info[2] =
// registers per thread, of the main kernel for k-step count nkm (3, 5, 8,
// 11, 18) at smem bytes of dynamic shared memory.
extern "C" int fci_sigma_occupancy(int nkm, int smem, int* info) {
  switch (nkm) {
    case 3: return (int)occupancy<3>(smem, info);
    case 5: return (int)occupancy<5>(smem, info);
    case 8: return (int)occupancy<8>(smem, info);
    case 11: return (int)occupancy<11>(smem, info);
    case 18: return (int)occupancy<18>(smem, info);
  }
  return (int)cudaErrorInvalidValue;
}
