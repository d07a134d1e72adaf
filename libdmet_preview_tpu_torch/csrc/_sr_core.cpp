// Native core for the periodic short-range Hermite kernel sums
// (the hot loop of ints/pbc.PbcCell._sr_flat_block: Ewald-split nuclear
// attraction and GTH local pseudopotential terms).
//
//   S[t,u,v, img] += sum_{k: kimg[k]=img} w[k] * R_{tuv}(alpha; PC_k)
//
// with R the Hermite derivative table of either the Coulomb kernel
// (Boys functions) or a Gaussian kernel e^{-alpha r^2} (optionally with
// complex alpha for complex-step derivatives w.r.t. the exponent), and
// the short-range ERI rows of the range-separated ERI (erfc_eri_rows_batch,
// on a pool of threads, each output element summed by one thread in a
// fixed order).  Plain C ABI via ctypes (no pybind11 in scope), same
// pattern as _gto_core.cpp.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int LMAX = 4;            // supports lsum <= 4 (up to d-d pairs)
const int NMAX = 3 * LMAX;     // max Hermite derivative order
const int LERI = 8;            // ERI quadruples: l12 + l34 <= 8 (dd|dd)
const int NERI = 3 * LERI;
const int KB = 3;              // doubles per ket pair in ket_bounds

// 1 / (2 j + 1), j < 200: the series below multiplies by these.
inline const double* inv_odd() {
    static const std::vector<double> tab = [] {
        std::vector<double> t(200);
        for (int j = 0; j < 200; ++j) t[j] = 1.0 / (2.0 * j + 1.0);
        return t;
    }();
    return tab.data();
}

// Boys functions F_0..F_n.  Three regimes: exact erf F_0 + upward
// recursion where that is stable (x comfortably above 2n: the series
// needs ~x terms there, so this is also the fast path for the
// mid-range lattice sums), series + downward recursion for small x,
// asymptotic + upward for very large x.
inline void boys(int n, double x, double* F) {
    if (n == 0) {  // exact closed form at every x
        if (x < 1e-14) F[0] = 1.0 - x / 3.0;
        else {
            double sx = std::sqrt(x);
            F[0] = 0.886226925452758014 / sx * std::erf(sx);
        }
        return;
    }
    if (x > 2.0 * n + 12.0 && x > 18.0) {
        double sx = std::sqrt(x);
        double ex = std::exp(-x);
        double tx = 2.0 * x;
        F[0] = 0.886226925452758014 / sx * std::erf(sx);  // sqrt(pi)/2
        for (int m = 0; m < n; ++m)
            F[m + 1] = ((2.0 * m + 1.0) * F[m] - ex) / tx;
    } else if (x < 35.0) {
        const double* inv = inv_odd();
        double term = inv[n];
        double acc = term;
        double tx = 2.0 * x;
        // the terms rise while 2x > 2n + 2k + 1, then fall faster than
        // geometrically: stop once one is below 1e-17 of the sum
        for (int k = 1; k < 140; ++k) {
            term *= tx * inv[n + k];
            acc += term;
            if (term < 1e-17 * acc) break;
        }
        double ex = std::exp(-x);
        F[n] = ex * acc;
        for (int m = n - 1; m >= 0; --m)
            F[m] = (tx * F[m + 1] + ex) * inv[m];
    } else {
        double ex = std::exp(-x);
        F[0] = 0.5 * std::sqrt(M_PI / x);
        for (int m = 0; m < n; ++m)
            F[m + 1] = ((2.0 * m + 1.0) * F[m] - ex) / (2.0 * x);
    }
}

// Boys functions F_0..F_n (1 <= n <= LERI) for the ERI rows: where boys()
// sums its series, an 8-term Taylor expansion about the nearest point of
// a 1/16 grid, F_n(x) = sum_k F_{n+k}(x_i) (x_i - x)^k / k! (remainder
// below 3e-17 relative), then the downward recursion; elsewhere boys().
// The grid values come from boys() once.
constexpr int BT_N = LERI + 8;            // orders F_0..F_{LERI+7}
constexpr int BT_PER = 16;                // grid points per unit of x
constexpr int BT_NX = 35 * BT_PER + 2;

inline const double* boys_grid() {
    static const std::vector<double> tab = [] {
        std::vector<double> t((size_t)BT_NX * BT_N);
        for (int i = 0; i < BT_NX; ++i)
            boys(BT_N - 1, (double)i / BT_PER, &t[(size_t)i * BT_N]);
        return t;
    }();
    return tab.data();
}

inline void boys_eri(int n, double x, double* F) {
    if ((x > 2.0 * n + 12.0 && x > 18.0) || x >= 35.0) {
        boys(n, x, F);
        return;
    }
    static const double rk[8] = {0.0, 1.0, 1.0 / 2, 1.0 / 3, 1.0 / 4,
                                 1.0 / 5, 1.0 / 6, 1.0 / 7};
    const int i = (int)(x * BT_PER + 0.5);
    const double d = (double)i / BT_PER - x;
    const double* Fi = boys_grid() + (size_t)i * BT_N;
    double acc = Fi[n + 7];
    for (int k = 7; k >= 1; --k) acc = Fi[n + k - 1] + acc * d * rk[k];
    F[n] = acc;
    const double* inv = inv_odd();
    const double ex = std::exp(-x), tx = 2.0 * x;
    for (int m = n - 1; m >= 0; --m)
        F[m] = (tx * F[m + 1] + ex) * inv[m];
}

// Hermite derivative table for one point; T = templated scalar
// (double or complex<double>), LM the compile-time l bound.
// R indexed [t][u][v], t,u,v <= lsum.
template <typename T, int LM>
inline void r_table_point(int lsum, T alpha, double px, double py,
                          double pz, const T* Fn, T R[LM + 1][LM + 1][LM + 1]) {
    const int nmax = 3 * lsum;
    // Rn[n][t][u][v] built by downward n recursion; small static array
    static thread_local T Rn[3 * LM + 1][LM + 1][LM + 1][LM + 1];
    for (int n = 0; n <= nmax; ++n) {
        T f = Fn[n];
        T m2a = 1.0;
        for (int k = 0; k < n; ++k) m2a *= (-2.0) * alpha;
        Rn[n][0][0][0] = m2a * f;
    }
    for (int n = nmax - 1; n >= 0; --n) {
        for (int t = 0; t <= lsum; ++t)
            for (int u = 0; u <= lsum; ++u)
                for (int v = 0; v <= lsum; ++v) {
                    int ord = t + u + v;
                    if (ord == 0 || ord > nmax - n) continue;
                    T val;
                    if (t > 0) {
                        val = px * Rn[n + 1][t - 1][u][v];
                        if (t > 1) val += (double)(t - 1) * Rn[n + 1][t - 2][u][v];
                    } else if (u > 0) {
                        val = py * Rn[n + 1][t][u - 1][v];
                        if (u > 1) val += (double)(u - 1) * Rn[n + 1][t][u - 2][v];
                    } else {
                        val = pz * Rn[n + 1][t][u][v - 1];
                        if (v > 1) val += (double)(v - 1) * Rn[n + 1][t][u][v - 2];
                    }
                    Rn[n][t][u][v] = val;
                }
    }
    for (int t = 0; t <= lsum; ++t)
        for (int u = 0; u <= lsum; ++u)
            for (int v = 0; v <= lsum; ++v)
                R[t][u][v] = Rn[0][t][u][v];
}

// Rsum[t][u][v] += R_tuv(p) for the entries t + u + v <= lsum (the only
// ones a Hermite -> Cartesian transform of total order lsum reads) by
// the recursion of r_table_point from the base values R^n_000 = base[n],
// n <= lsum.  The recursion is linear in the base values, so a sum of
// kernels (erfc = bare - erf) runs it once on the summed base.  The recursion steps of each lsum are listed once,
// ordered by t + u + v, so the level n runs a prefix of the list.
struct RStep {
    int dst, dir, src1, src2;    // flat (t, u, v) in a (LERI+1)^3 cube
    int oidx;                    // (t, u, v) in the plan's (lsum+1)^3 cube
    double mult;
};

struct RPlan {
    std::vector<RStep> steps;
    int count[LERI + 2];         // steps with t + u + v <= k: count[k]
};

inline const RPlan& r_plan(int lsum) {
    static const std::vector<RPlan> plans = [] {
        std::vector<RPlan> ps(LERI + 1);
        const int D = LERI + 1;
        for (int L = 0; L <= LERI; ++L) {
            RPlan& pl = ps[L];
            pl.count[0] = 0;
            for (int ord = 1; ord <= L; ++ord) {
                for (int t = 0; t <= ord; ++t)
                    for (int u = 0; u <= ord - t; ++u) {
                        const int v = ord - t - u;
                        RStep st;
                        st.dst = (t * D + u) * D + v;
                        st.oidx = (t * (L + 1) + u) * (L + 1) + v;
                        st.src2 = -1;
                        st.mult = 0.0;
                        if (t > 0) {
                            st.dir = 0;
                            st.src1 = ((t - 1) * D + u) * D + v;
                            if (t > 1) {
                                st.src2 = ((t - 2) * D + u) * D + v;
                                st.mult = t - 1;
                            }
                        } else if (u > 0) {
                            st.dir = 1;
                            st.src1 = (t * D + u - 1) * D + v;
                            if (u > 1) {
                                st.src2 = (t * D + u - 2) * D + v;
                                st.mult = u - 1;
                            }
                        } else {
                            st.dir = 2;
                            st.src1 = (t * D + u) * D + v - 1;
                            if (v > 1) {
                                st.src2 = (t * D + u) * D + v - 2;
                                st.mult = v - 1;
                            }
                        }
                        pl.steps.push_back(st);
                    }
                pl.count[ord] = (int)pl.steps.size();
            }
        }
        return ps;
    }();
    return plans[lsum];
}

inline void r_low_add(int lsum, const double* base, double px, double py,
                      double pz, double* Rsum) {
    constexpr int D3 = (LERI + 1) * (LERI + 1) * (LERI + 1);
    double A[D3], B[D3];
    double* nxt = A;
    double* cur = B;
    const RPlan& pl = r_plan(lsum);
    const RStep* st = pl.steps.data();
    const double pv[3] = {px, py, pz};
    nxt[0] = base[lsum];
    for (int n = lsum - 1; n >= 0; --n) {
        cur[0] = base[n];
        const int ns = pl.count[lsum - n];
        for (int k = 0; k < ns; ++k) {
            const RStep& s = st[k];
            double val = pv[s.dir] * nxt[s.src1];
            if (s.src2 >= 0) val += s.mult * nxt[s.src2];
            cur[s.dst] = val;
        }
        double* tmp = nxt;
        nxt = cur;
        cur = tmp;
    }
    Rsum[0] += nxt[0];
    const int ns = pl.count[lsum];
    for (int k = 0; k < ns; ++k) Rsum[st[k].dst] += nxt[st[k].dst];
}

// The same entries written to R (flat (LERI+1)^3 layout; the rest left
// as they were), for real or complex base values.
template <typename T>
inline void r_low_table(int lsum, const T* base, double px, double py,
                        double pz, T* R) {
    constexpr int D3 = (LERI + 1) * (LERI + 1) * (LERI + 1);
    T A[D3], B[D3];
    T* nxt = A;
    T* cur = B;
    const RPlan& pl = r_plan(lsum);
    const RStep* st = pl.steps.data();
    const double pv[3] = {px, py, pz};
    nxt[0] = base[lsum];
    for (int n = lsum - 1; n >= 0; --n) {
        cur[0] = base[n];
        const int ns = pl.count[lsum - n];
        for (int k = 0; k < ns; ++k) {
            const RStep& s = st[k];
            T val = pv[s.dir] * nxt[s.src1];
            if (s.src2 >= 0) val += s.mult * nxt[s.src2];
            cur[s.dst] = val;
        }
        T* tmp = nxt;
        nxt = cur;
        cur = tmp;
    }
    R[0] = nxt[0];
    const int ns = pl.count[lsum];
    for (int k = 0; k < ns; ++k) R[st[k].dst] = nxt[st[k].dst];
}

// r_low_add written out for lsum <= 4 (s and p shells), the same
// operations in the same order; generated from the recursion above.
inline void r_low_add_1(const double* base, double px, double py, double pz, double* Rsum) {
    const double r1_000 = base[1];
    const double r0_000 = base[0];
    const double r0_001 = pz * r1_000;
    const double r0_010 = py * r1_000;
    const double r0_100 = px * r1_000;
    Rsum[0] += r0_000;
    Rsum[1] += r0_001;
    Rsum[9] += r0_010;
    Rsum[81] += r0_100;
}

inline void r_low_add_2(const double* base, double px, double py, double pz, double* Rsum) {
    const double r2_000 = base[2];
    const double r1_000 = base[1];
    const double r1_001 = pz * r2_000;
    const double r1_010 = py * r2_000;
    const double r1_100 = px * r2_000;
    const double r0_000 = base[0];
    const double r0_001 = pz * r1_000;
    const double r0_010 = py * r1_000;
    const double r0_100 = px * r1_000;
    const double r0_002 = pz * r1_001 + 1.0 * r1_000;
    const double r0_011 = py * r1_001;
    const double r0_020 = py * r1_010 + 1.0 * r1_000;
    const double r0_101 = px * r1_001;
    const double r0_110 = px * r1_010;
    const double r0_200 = px * r1_100 + 1.0 * r1_000;
    Rsum[0] += r0_000;
    Rsum[1] += r0_001;
    Rsum[9] += r0_010;
    Rsum[81] += r0_100;
    Rsum[2] += r0_002;
    Rsum[10] += r0_011;
    Rsum[18] += r0_020;
    Rsum[82] += r0_101;
    Rsum[90] += r0_110;
    Rsum[162] += r0_200;
}

inline void r_low_add_3(const double* base, double px, double py, double pz, double* Rsum) {
    const double r3_000 = base[3];
    const double r2_000 = base[2];
    const double r2_001 = pz * r3_000;
    const double r2_010 = py * r3_000;
    const double r2_100 = px * r3_000;
    const double r1_000 = base[1];
    const double r1_001 = pz * r2_000;
    const double r1_010 = py * r2_000;
    const double r1_100 = px * r2_000;
    const double r1_002 = pz * r2_001 + 1.0 * r2_000;
    const double r1_011 = py * r2_001;
    const double r1_020 = py * r2_010 + 1.0 * r2_000;
    const double r1_101 = px * r2_001;
    const double r1_110 = px * r2_010;
    const double r1_200 = px * r2_100 + 1.0 * r2_000;
    const double r0_000 = base[0];
    const double r0_001 = pz * r1_000;
    const double r0_010 = py * r1_000;
    const double r0_100 = px * r1_000;
    const double r0_002 = pz * r1_001 + 1.0 * r1_000;
    const double r0_011 = py * r1_001;
    const double r0_020 = py * r1_010 + 1.0 * r1_000;
    const double r0_101 = px * r1_001;
    const double r0_110 = px * r1_010;
    const double r0_200 = px * r1_100 + 1.0 * r1_000;
    const double r0_003 = pz * r1_002 + 2.0 * r1_001;
    const double r0_012 = py * r1_002;
    const double r0_021 = py * r1_011 + 1.0 * r1_001;
    const double r0_030 = py * r1_020 + 2.0 * r1_010;
    const double r0_102 = px * r1_002;
    const double r0_111 = px * r1_011;
    const double r0_120 = px * r1_020;
    const double r0_201 = px * r1_101 + 1.0 * r1_001;
    const double r0_210 = px * r1_110 + 1.0 * r1_010;
    const double r0_300 = px * r1_200 + 2.0 * r1_100;
    Rsum[0] += r0_000;
    Rsum[1] += r0_001;
    Rsum[9] += r0_010;
    Rsum[81] += r0_100;
    Rsum[2] += r0_002;
    Rsum[10] += r0_011;
    Rsum[18] += r0_020;
    Rsum[82] += r0_101;
    Rsum[90] += r0_110;
    Rsum[162] += r0_200;
    Rsum[3] += r0_003;
    Rsum[11] += r0_012;
    Rsum[19] += r0_021;
    Rsum[27] += r0_030;
    Rsum[83] += r0_102;
    Rsum[91] += r0_111;
    Rsum[99] += r0_120;
    Rsum[163] += r0_201;
    Rsum[171] += r0_210;
    Rsum[243] += r0_300;
}

inline void r_low_add_4(const double* base, double px, double py, double pz, double* Rsum) {
    const double r4_000 = base[4];
    const double r3_000 = base[3];
    const double r3_001 = pz * r4_000;
    const double r3_010 = py * r4_000;
    const double r3_100 = px * r4_000;
    const double r2_000 = base[2];
    const double r2_001 = pz * r3_000;
    const double r2_010 = py * r3_000;
    const double r2_100 = px * r3_000;
    const double r2_002 = pz * r3_001 + 1.0 * r3_000;
    const double r2_011 = py * r3_001;
    const double r2_020 = py * r3_010 + 1.0 * r3_000;
    const double r2_101 = px * r3_001;
    const double r2_110 = px * r3_010;
    const double r2_200 = px * r3_100 + 1.0 * r3_000;
    const double r1_000 = base[1];
    const double r1_001 = pz * r2_000;
    const double r1_010 = py * r2_000;
    const double r1_100 = px * r2_000;
    const double r1_002 = pz * r2_001 + 1.0 * r2_000;
    const double r1_011 = py * r2_001;
    const double r1_020 = py * r2_010 + 1.0 * r2_000;
    const double r1_101 = px * r2_001;
    const double r1_110 = px * r2_010;
    const double r1_200 = px * r2_100 + 1.0 * r2_000;
    const double r1_003 = pz * r2_002 + 2.0 * r2_001;
    const double r1_012 = py * r2_002;
    const double r1_021 = py * r2_011 + 1.0 * r2_001;
    const double r1_030 = py * r2_020 + 2.0 * r2_010;
    const double r1_102 = px * r2_002;
    const double r1_111 = px * r2_011;
    const double r1_120 = px * r2_020;
    const double r1_201 = px * r2_101 + 1.0 * r2_001;
    const double r1_210 = px * r2_110 + 1.0 * r2_010;
    const double r1_300 = px * r2_200 + 2.0 * r2_100;
    const double r0_000 = base[0];
    const double r0_001 = pz * r1_000;
    const double r0_010 = py * r1_000;
    const double r0_100 = px * r1_000;
    const double r0_002 = pz * r1_001 + 1.0 * r1_000;
    const double r0_011 = py * r1_001;
    const double r0_020 = py * r1_010 + 1.0 * r1_000;
    const double r0_101 = px * r1_001;
    const double r0_110 = px * r1_010;
    const double r0_200 = px * r1_100 + 1.0 * r1_000;
    const double r0_003 = pz * r1_002 + 2.0 * r1_001;
    const double r0_012 = py * r1_002;
    const double r0_021 = py * r1_011 + 1.0 * r1_001;
    const double r0_030 = py * r1_020 + 2.0 * r1_010;
    const double r0_102 = px * r1_002;
    const double r0_111 = px * r1_011;
    const double r0_120 = px * r1_020;
    const double r0_201 = px * r1_101 + 1.0 * r1_001;
    const double r0_210 = px * r1_110 + 1.0 * r1_010;
    const double r0_300 = px * r1_200 + 2.0 * r1_100;
    const double r0_004 = pz * r1_003 + 3.0 * r1_002;
    const double r0_013 = py * r1_003;
    const double r0_022 = py * r1_012 + 1.0 * r1_002;
    const double r0_031 = py * r1_021 + 2.0 * r1_011;
    const double r0_040 = py * r1_030 + 3.0 * r1_020;
    const double r0_103 = px * r1_003;
    const double r0_112 = px * r1_012;
    const double r0_121 = px * r1_021;
    const double r0_130 = px * r1_030;
    const double r0_202 = px * r1_102 + 1.0 * r1_002;
    const double r0_211 = px * r1_111 + 1.0 * r1_011;
    const double r0_220 = px * r1_120 + 1.0 * r1_020;
    const double r0_301 = px * r1_201 + 2.0 * r1_101;
    const double r0_310 = px * r1_210 + 2.0 * r1_110;
    const double r0_400 = px * r1_300 + 3.0 * r1_200;
    Rsum[0] += r0_000;
    Rsum[1] += r0_001;
    Rsum[9] += r0_010;
    Rsum[81] += r0_100;
    Rsum[2] += r0_002;
    Rsum[10] += r0_011;
    Rsum[18] += r0_020;
    Rsum[82] += r0_101;
    Rsum[90] += r0_110;
    Rsum[162] += r0_200;
    Rsum[3] += r0_003;
    Rsum[11] += r0_012;
    Rsum[19] += r0_021;
    Rsum[27] += r0_030;
    Rsum[83] += r0_102;
    Rsum[91] += r0_111;
    Rsum[99] += r0_120;
    Rsum[163] += r0_201;
    Rsum[171] += r0_210;
    Rsum[243] += r0_300;
    Rsum[4] += r0_004;
    Rsum[12] += r0_013;
    Rsum[20] += r0_022;
    Rsum[28] += r0_031;
    Rsum[36] += r0_040;
    Rsum[84] += r0_103;
    Rsum[92] += r0_112;
    Rsum[100] += r0_121;
    Rsum[108] += r0_130;
    Rsum[164] += r0_202;
    Rsum[172] += r0_211;
    Rsum[180] += r0_220;
    Rsum[244] += r0_301;
    Rsum[252] += r0_310;
    Rsum[324] += r0_400;
}

// Which E-table entries a Cartesian shell pair (la, lb <= 2) can hold:
// E[c = i*nc_b + j][(t, u, v)] with t <= lx_i + lx_j, u <= ly_i + ly_j,
// v <= lz_i + lz_j (md.CART order).  For a pair on the ket side also the
// union of those (t, u, v) over c, with their parities.
struct PairNZ {
    std::vector<int> start;    // entries of c: [start[c], start[c + 1])
    std::vector<int> eidx;     // E column t*(l+1)^2 + u*(l+1) + v
    std::vector<int> roff;     // Rsum offset ((t*D) + u)*D + v
    std::vector<int> upos;     // position of (t, u, v) in the union
    std::vector<int> uroff;    // union entries' Rsum offsets
    std::vector<double> usgn;  // (-1)^(t+u+v) of the union entries
};

inline int l_of_nc(int64_t nc) { return nc == 1 ? 0 : (nc == 3 ? 1 : 2); }

inline const PairNZ& pair_nz(int la, int lb) {
    static const std::vector<PairNZ> tab = [] {
        static const int CART[3][6][3] = {
            {{0, 0, 0}},
            {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}},
            {{2, 0, 0}, {1, 1, 0}, {1, 0, 1}, {0, 2, 0}, {0, 1, 1},
             {0, 0, 2}}};
        const int NC[3] = {1, 3, 6};
        const int D = LERI + 1;
        std::vector<PairNZ> out(9);
        for (int la = 0; la < 3; ++la)
            for (int lb = 0; lb < 3; ++lb) {
                PairNZ& z = out[la * 3 + lb];
                const int n = la + lb + 1;
                std::vector<int> uni(n * n * n, -1);
                for (int i = 0; i < NC[la]; ++i)
                    for (int j = 0; j < NC[lb]; ++j) {
                        z.start.push_back((int)z.eidx.size());
                        const int* a = CART[la][i];
                        const int* b = CART[lb][j];
                        for (int t = 0; t <= a[0] + b[0]; ++t)
                            for (int u = 0; u <= a[1] + b[1]; ++u)
                                for (int v = 0; v <= a[2] + b[2]; ++v) {
                                    const int e = (t * n + u) * n + v;
                                    if (uni[e] < 0) {
                                        uni[e] = (int)z.uroff.size();
                                        z.uroff.push_back((t * D + u) * D + v);
                                        z.usgn.push_back(((t + u + v) & 1)
                                                         ? -1.0 : 1.0);
                                    }
                                    z.eidx.push_back(e);
                                    z.roff.push_back((t * D + u) * D + v);
                                    z.upos.push_back(uni[e]);
                                }
                    }
                z.start.push_back((int)z.eidx.size());
            }
        return out;
    }();
    return tab[la * 3 + lb];
}

}  // namespace

// sr_cand_sum with low = 1: only the entries t + u + v <= lsum of S (the
// rest untouched), by r_low_table; the Coulomb kernel's Boys values from
// boys_eri.  A caller that reads only those entries (a Hermite ->
// Cartesian transform of total order lsum) gets them ~10x faster.
static void sr_cand_sum_low(int L, int64_t ncand, int64_t nimg_p,
                            const double* P, const int64_t* inv,
                            const int64_t* cand_img, const int64_t* cand_c,
                            const double* ctrs, const double* Zs,
                            double rng2, double alpha_re, double alpha_im,
                            int64_t kernel, double* S_re, double* S_im) {
    constexpr int D3 = (LERI + 1) * (LERI + 1) * (LERI + 1);
    const RPlan& pl = r_plan(L);
    const int ns = pl.count[L];
    if (kernel == 0) {
        double Fn[NERI + 1], base[NERI + 1], R[D3];
        for (int64_t k = 0; k < ncand; ++k) {
            int64_t l = inv[cand_img[k]];
            if (l < 0) continue;
            int64_t c = cand_c[k];
            double px = P[3 * l] - ctrs[3 * c];
            double py = P[3 * l + 1] - ctrs[3 * c + 1];
            double pz = P[3 * l + 2] - ctrs[3 * c + 2];
            double r2 = px * px + py * py + pz * pz;
            if (r2 >= rng2) continue;
            if (L == 0) boys(0, alpha_re * r2, Fn);
            else boys_eri(L, alpha_re * r2, Fn);
            double m = 1.0;
            for (int n = 0; n <= L; ++n) {
                base[n] = m * Fn[n];
                m *= -2.0 * alpha_re;
            }
            r_low_table<double>(L, base, px, py, pz, R);
            const double w = Zs[c];
            double* out = S_re + l;
            out[0] += w * R[0];
            for (int q = 0; q < ns; ++q)
                out[(int64_t)pl.steps[q].oidx * nimg_p] +=
                    w * R[pl.steps[q].dst];
        }
    } else {
        const std::complex<double> alpha(alpha_re, alpha_im);
        std::complex<double> base[NERI + 1], R[D3];
        for (int64_t k = 0; k < ncand; ++k) {
            int64_t l = inv[cand_img[k]];
            if (l < 0) continue;
            int64_t c = cand_c[k];
            double px = P[3 * l] - ctrs[3 * c];
            double py = P[3 * l + 1] - ctrs[3 * c + 1];
            double pz = P[3 * l + 2] - ctrs[3 * c + 2];
            double r2 = px * px + py * py + pz * pz;
            if (r2 >= rng2) continue;
            const std::complex<double> e = std::exp(-alpha * r2);
            std::complex<double> m = 1.0;
            for (int n = 0; n <= L; ++n) {
                base[n] = m * e;
                m *= (-2.0) * alpha;
            }
            r_low_table<std::complex<double>>(L, base, px, py, pz, R);
            const double w = Zs[c];
            double* outr = S_re + l;
            double* outi = S_im + l;
            outr[0] += w * R[0].real();
            outi[0] += w * R[0].imag();
            for (int q = 0; q < ns; ++q) {
                const int64_t o = (int64_t)pl.steps[q].oidx * nimg_p;
                const std::complex<double> v = R[pl.steps[q].dst];
                outr[o] += w * v.real();
                outi[o] += w * v.imag();
            }
        }
    }
}

extern "C" {

// kernel = 0: Coulomb (Boys); alpha_im ignored.
// kernel = 1: Gaussian e^{-alpha r^2}, alpha possibly complex
//             (complex-step; imag parts returned in S_im).
// S_re/S_im: ((lsum+1)^3, nimg) row-major, ACCUMULATED (+=).
void sr_hermite_sum(int64_t lsum, int64_t nact, int64_t nimg,
                    const double* PC, const double* wz,
                    const int64_t* kimg,
                    double alpha_re, double alpha_im, int64_t kernel,
                    double* S_re, double* S_im) {
    const int L = (int)lsum;
    const int dim = (L + 1) * (L + 1) * (L + 1);
    const int nmax = 3 * L;
    (void)nimg;

    if (kernel == 0) {
        double Fn[NMAX + 1];
        double R[LMAX + 1][LMAX + 1][LMAX + 1];
        for (int64_t k = 0; k < nact; ++k) {
            double px = PC[3 * k], py = PC[3 * k + 1], pz = PC[3 * k + 2];
            double T = alpha_re * (px * px + py * py + pz * pz);
            boys(nmax, T, Fn);
            r_table_point<double, LMAX>(L, alpha_re, px, py, pz, Fn, R);
            double w = wz[k];
            double* out = S_re + kimg[k];
            int idx = 0;
            for (int t = 0; t <= L; ++t)
                for (int u = 0; u <= L; ++u)
                    for (int v = 0; v <= L; ++v, ++idx)
                        out[(int64_t)idx * nimg] += w * R[t][u][v];
        }
    } else {
        std::complex<double> alpha(alpha_re, alpha_im);
        std::complex<double> Fn[NMAX + 1];
        std::complex<double> R[LMAX + 1][LMAX + 1][LMAX + 1];
        for (int64_t k = 0; k < nact; ++k) {
            double px = PC[3 * k], py = PC[3 * k + 1], pz = PC[3 * k + 2];
            std::complex<double> T =
                alpha * (px * px + py * py + pz * pz);
            std::complex<double> e = std::exp(-T);
            for (int n = 0; n <= nmax; ++n) Fn[n] = e;
            r_table_point<std::complex<double>, LMAX>(L, alpha, px, py, pz,
                                                 Fn, R);
            double w = wz[k];
            double* outr = S_re + kimg[k];
            double* outi = S_im + kimg[k];
            int idx = 0;
            for (int t = 0; t <= L; ++t)
                for (int u = 0; u <= L; ++u)
                    for (int v = 0; v <= L; ++v, ++idx) {
                        outr[(int64_t)idx * nimg] += w * R[t][u][v].real();
                        outi[(int64_t)idx * nimg] += w * R[t][u][v].imag();
                    }
        }
    }
    (void)dim;
}

// Fused candidate screen + Hermite kernel sum: moves the per-primitive
// bookkeeping of ints/pbc.PbcCell._sr_flat_block (image remap, product
// center - lattice center differences, exact range screen, weight
// gather) into the same pass as the kernel evaluation, so Python only
// builds the shell-level candidate list once per shell pair.
//
//   for k in candidates:
//     l = inv[cand_img[k]]           (primitive's surviving-image remap)
//     if l < 0: skip
//     PC = P[l] - ctrs[cand_c[k]]
//     if |PC|^2 >= rng2: skip
//     S[:, l] += Zs[cand_c[k]] * R_tuv(alpha; PC)
//
// kernel = 0: Coulomb (Boys); kernel = 1: Gaussian with complex-step
// alpha (imag in S_im).  S_re/S_im: ((lsum+1)^3, nimg_p), ACCUMULATED;
// low = 1: only the entries t + u + v <= lsum (sr_cand_sum_low).
void sr_cand_sum(int64_t lsum, int64_t ncand, int64_t nimg_p,
                 const double* P, const int64_t* inv,
                 const int64_t* cand_img, const int64_t* cand_c,
                 const double* ctrs, const double* Zs, double rng2,
                 double alpha_re, double alpha_im, int64_t kernel,
                 int64_t low, double* S_re, double* S_im) {
    const int L = (int)lsum;
    const int nmax = 3 * L;
    if (low) {
        sr_cand_sum_low(L, ncand, nimg_p, P, inv, cand_img, cand_c, ctrs,
                        Zs, rng2, alpha_re, alpha_im, kernel, S_re, S_im);
        return;
    }

    if (kernel == 0) {
        double Fn[NMAX + 1];
        double R[LMAX + 1][LMAX + 1][LMAX + 1];
        for (int64_t k = 0; k < ncand; ++k) {
            int64_t l = inv[cand_img[k]];
            if (l < 0) continue;
            int64_t c = cand_c[k];
            double px = P[3 * l] - ctrs[3 * c];
            double py = P[3 * l + 1] - ctrs[3 * c + 1];
            double pz = P[3 * l + 2] - ctrs[3 * c + 2];
            double r2 = px * px + py * py + pz * pz;
            if (r2 >= rng2) continue;
            boys(nmax, alpha_re * r2, Fn);
            r_table_point<double, LMAX>(L, alpha_re, px, py, pz, Fn, R);
            double w = Zs[c];
            double* out = S_re + l;
            int idx = 0;
            for (int t = 0; t <= L; ++t)
                for (int u = 0; u <= L; ++u)
                    for (int v = 0; v <= L; ++v, ++idx)
                        out[(int64_t)idx * nimg_p] += w * R[t][u][v];
        }
    } else {
        std::complex<double> alpha(alpha_re, alpha_im);
        std::complex<double> Fn[NMAX + 1];
        std::complex<double> R[LMAX + 1][LMAX + 1][LMAX + 1];
        for (int64_t k = 0; k < ncand; ++k) {
            int64_t l = inv[cand_img[k]];
            if (l < 0) continue;
            int64_t c = cand_c[k];
            double px = P[3 * l] - ctrs[3 * c];
            double py = P[3 * l + 1] - ctrs[3 * c + 1];
            double pz = P[3 * l + 2] - ctrs[3 * c + 2];
            double r2 = px * px + py * py + pz * pz;
            if (r2 >= rng2) continue;
            std::complex<double> e = std::exp(-alpha * r2);
            for (int n = 0; n <= nmax; ++n) Fn[n] = e;
            r_table_point<std::complex<double>, LMAX>(L, alpha, px, py, pz,
                                                 Fn, R);
            double w = Zs[c];
            double* outr = S_re + l;
            double* outi = S_im + l;
            int idx = 0;
            for (int t = 0; t <= L; ++t)
                for (int u = 0; u <= L; ++u)
                    for (int v = 0; v <= L; ++v, ++idx) {
                        outr[(int64_t)idx * nimg_p] += w * R[t][u][v].real();
                        outi[(int64_t)idx * nimg_p] += w * R[t][u][v].imag();
                    }
        }
    }
}

// Image-summed SHORT-RANGE (erfc(w r)/r) ERI rows for the periodic
// range-separated ERI (ints/pbc.PbcCell._sr_ao_eri_rows): one BRA
// shell pair and image (first index in cell 0) against ALL ket pairs, all
// lattice images, accumulated straight into the (m, nao, nao, nao)
// first-block-row ERI tensor.
//
// Math per primitive pair (a in bra, b in ket), per image T:
//   alpha = p q/(p+q); theta = alpha w^2/(alpha + w^2)
//   Rsum += R(alpha; P-Q-T) - sqrt(theta/alpha) R(theta; P-Q-T)
// then the doubly-contracted Hermite->Cartesian transform
//   out[ij, kl] += fac * E12[a][ij, tuv] (-1)^{tau+nu+phi}
//                  Rsum[t+tau, u+nu, v+phi] E34[b][kl, tau nu phi]
// as two small GEMMs (E12 . R2, then . E34^T).  Screening: a ket pair
// (and then a bra primitive) is skipped when a bound on every
// quadruple's magnitude fails the magnitude screen below (exact: those
// quadruples add nothing there either); then the exact primitive
// range |P-Q-T| < sqrt(lntol)/w + sqrt(lntol/alpha) (the erfc decay
// range plus the Gaussian-pair width), mirroring the pure-Python
// oracle ints/md.eri_block_erfc_tsum.
//
// Layouts (all C-contiguous, caller-packed):
//   pc12/pc34: (nprim_pairs, 6) = p, c, Px, Py, Pz, max|E|
//   E12:  (np12, nc1*nc2, (l12+1)^3)  dense per-primitive E tables
//   E34:  concatenation of (np34_kp, nc3*nc4, (l34+1)^3) blocks
//   kmeta: (nkp, 8) int64 = l34, nc3, nc4, prim_off, prim_len,
//          E34_off (doubles), out_off (= k0*s2 + l0), out_off_T
//          (= l0*s2 + k0 for the (pq|sr) ket-swap partner block of a
//          CANONICAL ket pair list, or -1 for a self pair: real
//          orbitals give (0p Jq | Kr Ls) = (0p Jq | Ls Kr), so the
//          caller enumerates only k<l (plus one of +/-T for k==l) and
//          this kernel scatters both the block and its transpose --
//          the expensive Boys/Hermite/GEMM work runs once per
//          unordered ket pair)
//   kbound: (nkp, KB) from ket_bounds; kvb: |c_b| E_b / q_b per ket
//          primitive pair
//   A / cnorm: lattice row vectors (T = n . A) and the column norms of
//          A^{-1} -- images are ENUMERATED per primitive pair as the
//          fractional-coordinate subbox |n_i - f_i| <= rc * cnorm_i
//          around f = (P - Q) A^{-1} (exact: |x - nA| < rc implies
//          each |f_i - n_i| <= rc ||col_i A^{-1}||), so the work per
//          primitive pair is O(surviving images), independent of the
//          global image-list length.
//   out: base pointer ALREADY offset by i0*s0 + j0*s1; strides
//        s0 (i), s1 (j), s2 (k); l stride 1.
static void erfc_eri_rows_one(
        int64_t l12, int64_t nc1, int64_t nc2, int64_t np12,
        const double* pc12, const double* E12,
        int64_t nkp, const int64_t* kmeta, const double* pc34,
        const double* E34, const double* kbound, const double* kvb,
        const double* A, const double* Ainv, const double* cnorm,
        double omega, double lntol, int64_t s0, int64_t s1, int64_t s2,
        double* out) {
    const double w2 = omega * omega;
    const double sql = std::sqrt(lntol);
    const int h12 = (int)((l12 + 1) * (l12 + 1) * (l12 + 1));
    const int nc12 = (int)(nc1 * nc2);
    const double TWO_PI_2_5 = 2.0 * 17.493418327624862;  // 2 pi^2.5
    // this bra's half of the ket-level magnitude bound (see kbound)
    double bmax = 0.0, pmin = 1e300;
    for (int64_t a = 0; a < np12; ++a) {
        const double v = std::fabs(pc12[6 * a + 1]) * pc12[6 * a + 5]
            / pc12[6 * a];
        if (v > bmax) bmax = v;
        if (pc12[6 * a] < pmin) pmin = pc12[6 * a];
    }
    const double lbra = std::log(TWO_PI_2_5 * bmax / std::sqrt(pmin));
    const double prec_lo = std::exp(-lntol) * (1.0 - 1e-9);

    const PairNZ& BZ = pair_nz(l_of_nc(nc1), l_of_nc(nc2));
    double tm[36 * 35];                       // nc12 x union (l <= 2)
    double Rsum[LERI + 1][LERI + 1][LERI + 1];
    double Fn[NERI + 1], Ft[NERI + 1], base[NERI + 1];

    for (int64_t kp = 0; kp < nkp; ++kp) {
        const int64_t l34 = kmeta[8 * kp];
        const int64_t nc3 = kmeta[8 * kp + 1];
        const int64_t nc4 = kmeta[8 * kp + 2];
        const int64_t p_off = kmeta[8 * kp + 3];
        const int64_t p_len = kmeta[8 * kp + 4];
        const int64_t e_off = kmeta[8 * kp + 5];
        const int64_t out_off = kmeta[8 * kp + 6];
        const int64_t out_off_T = kmeta[8 * kp + 7];
        const int h34 = (int)((l34 + 1) * (l34 + 1) * (l34 + 1));
        const int nc34 = (int)(nc3 * nc4);
        const PairNZ& KZ = pair_nz(l_of_nc(nc3), l_of_nc(nc4));
        const int nu = (int)KZ.uroff.size();
        const int lsum = (int)(l12 + l34);
        // every primitive quadruple of this ket pair has
        //   Amag <= 2 pi^2.5 bmax kmax / sqrt(pmin + qmin)
        // (Amag = |cA cB| eA eB 2 pi^2.5 / (p q sqrt(p + q)) below), so
        // when that bound (with a 1e-6 margin for rounding) fails the
        // magnitude screen, every quadruple would be skipped there: the
        // skip changes no sum
        const double* kb = kbound + KB * kp;
        // (first the looser bound without qmin: one addition)
        if (lbra + kb[2] + 1e-6 + lntol <= 0.0) continue;
        if (std::log(TWO_PI_2_5 * bmax * kb[0] / std::sqrt(pmin + kb[1]))
                + 1e-6 + lntol <= 0.0)
            continue;

        for (int64_t a = 0; a < np12; ++a) {
            const double p = pc12[6 * a], cA = pc12[6 * a + 1];
            const double Px = pc12[6 * a + 2], Py = pc12[6 * a + 3],
                         Pz = pc12[6 * a + 4];
            const double eA = pc12[6 * a + 5];
            // the same bound for this bra primitive alone
            const double va = TWO_PI_2_5 * std::fabs(cA) * eA / p
                / std::sqrt(p + kb[1]);
            if (std::log(va * kb[0]) + 1e-6 + lntol <= 0.0) continue;
            for (int64_t b = p_off; b < p_off + p_len; ++b) {
                // Amag <= va |cB| eB / q (sqrt(p + q) >= sqrt(p + qmin))
                if (va * kvb[b] <= prec_lo) continue;
                const double q = pc34[6 * b], cB = pc34[6 * b + 1];
                const double ex = Px - pc34[6 * b + 2];
                const double ey = Py - pc34[6 * b + 3];
                const double ez = Pz - pc34[6 * b + 4];
                const double eB = pc34[6 * b + 5];
                const double fac0 = TWO_PI_2_5
                    / (p * q * std::sqrt(p + q));
                // magnitude-aware range: the SR kernel decays as
                // exp(-theta r^2)/r and the whole term carries the
                // E-table magnitudes, so images beyond
                //   Amag exp(-theta r^2) < prec  (prec = e^{-lntol})
                // are dropped (mirrors the kernel-only bound
                // sqrt(lntol)/w + sqrt(lntol/alpha) but collapses for
                // weak overlap pairs).  Amag below prec_lo < prec fails
                // that screen without the logarithm.
                const double Amag = std::fabs(cA * cB) * eA * eB * fac0;
                if (Amag <= prec_lo) continue;
                const double lAm = std::log(Amag) + lntol;
                if (lAm <= 0.0) continue;
                const double alpha = p * q / (p + q);
                const double theta = alpha * w2 / (alpha + w2);
                const double sc = std::sqrt(theta / alpha);
                double rc = sql / omega + std::sqrt(lntol / alpha);
                const double rb = std::sqrt(lAm / theta) + 1.0;
                if (rb < rc) rc = rb;
                const double rc2 = rc * rc;
                // fractional subbox of images around e = P - Q
                const double f0 = ex * Ainv[0] + ey * Ainv[3]
                    + ez * Ainv[6];
                const double f1 = ex * Ainv[1] + ey * Ainv[4]
                    + ez * Ainv[7];
                const double f2 = ex * Ainv[2] + ey * Ainv[5]
                    + ez * Ainv[8];
                const long n0l = (long)std::ceil(f0 - rc * cnorm[0]);
                const long n0h = (long)std::floor(f0 + rc * cnorm[0]);
                const long n1l = (long)std::ceil(f1 - rc * cnorm[1]);
                const long n1h = (long)std::floor(f1 + rc * cnorm[1]);
                const long n2l = (long)std::ceil(f2 - rc * cnorm[2]);
                const long n2h = (long)std::floor(f2 + rc * cnorm[2]);
                int n_in = 0;
                for (long na = n0l; na <= n0h; ++na)
                    for (long nb = n1l; nb <= n1h; ++nb)
                        for (long ncl = n2l; ncl <= n2h; ++ncl) {
                    const double Tx = na * A[0] + nb * A[3] + ncl * A[6];
                    const double Ty = na * A[1] + nb * A[4] + ncl * A[7];
                    const double Tz = na * A[2] + nb * A[5] + ncl * A[8];
                    const double px = ex - Tx;
                    const double py = ey - Ty;
                    const double pz = ez - Tz;
                    const double r2 = px * px + py * py + pz * pz;
                    if (r2 >= rc2) continue;
                    if (n_in == 0)
                        for (int t1 = 0; t1 <= lsum; ++t1)
                            for (int u1 = 0; u1 <= lsum - t1; ++u1)
                                for (int v1 = 0; v1 <= lsum - t1 - u1; ++v1)
                                    Rsum[t1][u1][v1] = 0.0;
                    ++n_in;
                    if (lsum == 0) {  // s quadruple: F0 only
                        double fa, ft;
                        boys(0, alpha * r2, &fa);
                        boys(0, theta * r2, &ft);
                        Rsum[0][0][0] += fa - sc * ft;
                        continue;
                    }
                    // only t + u + v <= lsum: the E tables are zero
                    // above it, so the transform below never reads the
                    // rest (they stay 0)
                    // R^n_000 of erfc = bare - erf:
                    //   (-2 alpha)^n F_n(alpha r2)
                    //     - sc (-2 theta)^n F_n(theta r2)
                    boys_eri(lsum, alpha * r2, Fn);
                    boys_eri(lsum, theta * r2, Ft);
                    double ma = 1.0, mt = sc;
                    for (int n = 0; n <= lsum; ++n) {
                        base[n] = ma * Fn[n] - mt * Ft[n];
                        ma *= -2.0 * alpha;
                        mt *= -2.0 * theta;
                    }
                    double* Rf = &Rsum[0][0][0];
                    switch (lsum) {
                        case 1: r_low_add_1(base, px, py, pz, Rf); break;
                        case 2: r_low_add_2(base, px, py, pz, Rf); break;
                        case 3: r_low_add_3(base, px, py, pz, Rf); break;
                        case 4: r_low_add_4(base, px, py, pz, Rf); break;
                        default: r_low_add(lsum, base, px, py, pz, Rf);
                    }
                }
                if (n_in == 0) continue;
                const double fac = cA * cB * TWO_PI_2_5
                    / (p * q * std::sqrt(p + q));
                // tm[c, g] = (-1)^{tau+nu+phi} sum_h E12[a][c, h]
                //            Rsum[t+tau, u+nu, v+phi]
                // over the entries the E tables can hold (PairNZ)
                const double* Ea = E12 + (int64_t)a * nc12 * h12;
                const double* Rf = &Rsum[0][0][0];
                for (int c = 0; c < nc12; ++c) {
                    double* tr = tm + (int64_t)c * nu;
                    for (int g = 0; g < nu; ++g) tr[g] = 0.0;
                    const double* er = Ea + (int64_t)c * h12;
                    for (int k = BZ.start[c]; k < BZ.start[c + 1]; ++k) {
                        const double e = er[BZ.eidx[k]];
                        if (e == 0.0) continue;
                        const double* rr = Rf + BZ.roff[k];
                        for (int g = 0; g < nu; ++g)
                            tr[g] += e * rr[KZ.uroff[g]];
                    }
                    for (int g = 0; g < nu; ++g) tr[g] *= KZ.usgn[g];
                }
                // out[ij, kl] += fac * tm . E34[b]^T
                const double* Eb = E34 + e_off
                    + (b - p_off) * (int64_t)nc34 * h34;
                for (int c = 0; c < nc12; ++c) {
                    const int i = c / (int)nc2, j = c % (int)nc2;
                    double* ob = out + i * s0 + j * s1 + out_off;
                    double* obT = (out_off_T >= 0)
                        ? out + i * s0 + j * s1 + out_off_T : nullptr;
                    const double* tr = tm + (int64_t)c * nu;
                    for (int d = 0; d < nc34; ++d) {
                        const double* eb = Eb + (int64_t)d * h34;
                        double acc = 0.0;
                        for (int k = KZ.start[d]; k < KZ.start[d + 1]; ++k)
                            acc += tr[KZ.upos[k]] * eb[KZ.eidx[k]];
                        const int kk = d / (int)nc4, l = d % (int)nc4;
                        const double v = fac * acc;
                        ob[kk * s2 + l] += v;
                        if (obT) obT[l * s2 + kk] += v;
                    }
                }
            }
        }
    }
}

// Ket-level bound data for erfc_eri_rows_one, KB doubles per ket pair
// over its primitive pairs: max_b |c_b| E_b / q_b, min_b q_b and the
// logarithm of the first.
static void ket_bounds(int64_t nkp, const int64_t* kmeta,
                       const double* pc34, double* kbound) {
    for (int64_t kp = 0; kp < nkp; ++kp) {
        const int64_t p_off = kmeta[8 * kp + 3];
        const int64_t p_len = kmeta[8 * kp + 4];
        double kmax = 0.0, qmin = 1e300;
        for (int64_t b = p_off; b < p_off + p_len; ++b) {
            const double v = std::fabs(pc34[6 * b + 1]) * pc34[6 * b + 5]
                / pc34[6 * b];
            if (v > kmax) kmax = v;
            if (pc34[6 * b] < qmin) qmin = pc34[6 * b];
        }
        double* kb = kbound + KB * kp;
        kb[0] = kmax;
        kb[1] = qmin;
        kb[2] = std::log(kmax);
    }
}

// All bra shell pairs at once, on nthreads threads.
//   bmeta: (nbra, 7) int64 = l12, nc1, nc2, prim_off, prim_len,
//          E12_off (doubles), out_off (= i0*s0 + j0*s1)
//   pc12 / E12: the bras' primitive data, packed like pc34 / E34
//   groups: group g is the bras [goff[g], goff[g+1]) (one (i, j) shell
//          pair: its bras write the same output slab, in list order);
//          distinct groups write disjoint slabs of out, so a thread takes
//          a whole group and every output element is summed in the order
//          of one thread.  gorder: the order in which groups are handed
//          out (largest first; it does not change any sum).
void erfc_eri_rows_batch(int64_t nbra, const int64_t* bmeta,
                         const double* pc12, const double* E12,
                         int64_t ngroup, const int64_t* goff,
                         const int64_t* gorder,
                         int64_t nkp, const int64_t* kmeta,
                         const double* pc34, const double* E34,
                         const double* A, const double* Ainv,
                         const double* cnorm,
                         double omega, double lntol,
                         int64_t s0, int64_t s1, int64_t s2,
                         int64_t nthreads, double* out) {
    (void)nbra;
    std::vector<double> kbound(KB * (size_t)nkp);
    ket_bounds(nkp, kmeta, pc34, kbound.data());
    // |c_b| E_b / q_b of every ket primitive pair
    int64_t nprim34 = 0;
    for (int64_t kp = 0; kp < nkp; ++kp)
        nprim34 = std::max(nprim34, kmeta[8 * kp + 3] + kmeta[8 * kp + 4]);
    std::vector<double> kvb((size_t)nprim34);
    for (int64_t b = 0; b < nprim34; ++b)
        kvb[b] = std::fabs(pc34[6 * b + 1]) * pc34[6 * b + 5] / pc34[6 * b];
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (;;) {
            const int64_t gi = next.fetch_add(1);
            if (gi >= ngroup) return;
            const int64_t g = gorder[gi];
            for (int64_t k = goff[g]; k < goff[g + 1]; ++k) {
                const int64_t* bm = bmeta + 7 * k;
                erfc_eri_rows_one(bm[0], bm[1], bm[2], bm[4],
                                  pc12 + 6 * bm[3], E12 + bm[5],
                                  nkp, kmeta, pc34, E34, kbound.data(),
                                  kvb.data(),
                                  A, Ainv, cnorm, omega, lntol,
                                  s0, s1, s2, out + bm[6]);
            }
        }
    };
    if (nthreads <= 1 || ngroup <= 1) {
        work();
        return;
    }
    std::vector<std::thread> pool;
    const int64_t nt = nthreads < ngroup ? nthreads : ngroup;
    for (int64_t t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

}  // extern "C"
