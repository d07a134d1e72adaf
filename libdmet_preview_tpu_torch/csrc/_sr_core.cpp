// Native core for the periodic short-range Hermite kernel sums
// (the hot loop of ints/pbc.PbcCell._sr_flat_block: Ewald-split nuclear
// attraction and GTH local pseudopotential terms).
//
//   S[t,u,v, img] += sum_{k: kimg[k]=img} w[k] * R_{tuv}(alpha; PC_k)
//
// with R the Hermite derivative table of either the Coulomb kernel
// (Boys functions) or a Gaussian kernel e^{-alpha r^2} (optionally with
// complex alpha for complex-step derivatives w.r.t. the exponent).
// Plain C ABI via ctypes (no pybind11 in scope), same pattern as
// _gto_core.cpp.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

namespace {

const int LMAX = 4;            // supports lsum <= 4 (up to d-d pairs)
const int NMAX = 3 * LMAX;     // max Hermite derivative order
const int LERI = 8;            // ERI quadruples: l12 + l34 <= 8 (dd|dd)
const int NERI = 3 * LERI;

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
        double term = 1.0 / (2.0 * n + 1.0);
        double acc = term;
        double tx = 2.0 * x;
        for (int k = 1; k < 140; ++k) {
            term *= tx / (2.0 * n + 2.0 * k + 1.0);
            acc += term;
            if (k > 20 && term < 1e-18) break;
        }
        double ex = std::exp(-x);
        F[n] = ex * acc;
        for (int m = n - 1; m >= 0; --m)
            F[m] = (tx * F[m + 1] + ex) / (2.0 * m + 1.0);
    } else {
        double ex = std::exp(-x);
        F[0] = 0.5 * std::sqrt(M_PI / x);
        for (int m = 0; m < n; ++m)
            F[m + 1] = ((2.0 * m + 1.0) * F[m] - ex) / (2.0 * x);
    }
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

}  // namespace

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
// alpha (imag in S_im).  S_re/S_im: ((lsum+1)^3, nimg_p), ACCUMULATED.
void sr_cand_sum(int64_t lsum, int64_t ncand, int64_t nimg_p,
                 const double* P, const int64_t* inv,
                 const int64_t* cand_img, const int64_t* cand_c,
                 const double* ctrs, const double* Zs, double rng2,
                 double alpha_re, double alpha_im, int64_t kernel,
                 double* S_re, double* S_im) {
    const int L = (int)lsum;
    const int nmax = 3 * L;

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
// shell pair (first index in cell 0) against ALL ket shell pairs, all
// lattice images, accumulated straight into the (m, nao, nao, nao)
// first-block-row ERI tensor.
//
// Math per primitive pair (a in bra, b in ket), per image T:
//   alpha = p q/(p+q); theta = alpha w^2/(alpha + w^2)
//   Rsum += R(alpha; P-Q-T) - sqrt(theta/alpha) R(theta; P-Q-T)
// then the doubly-contracted Hermite->Cartesian transform
//   out[ij, kl] += fac * E12[a][ij, tuv] (-1)^{tau+nu+phi}
//                  Rsum[t+tau, u+nu, v+phi] E34[b][kl, tau nu phi]
// as two small GEMMs (E12 . R2, then . E34^T).  Screening: shell-level
// image keep |Pm-Qm-T| < rcut_sh + Pr + Qr, then the exact primitive
// range |P-Q-T| < sqrt(lntol)/w + sqrt(lntol/alpha) (the erfc decay
// range plus the Gaussian-pair width), mirroring the pure-Python
// oracle ints/md.eri_block_erfc_tsum.
//
// Layouts (all C-contiguous, caller-packed):
//   pc12/pc34: (nprim_pairs, 5) = p, c, Px, Py, Pz
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
//   kgeom: (nkp, 4) = Qmx, Qmy, Qmz, Qr (Qr unused; kept for layout)
//   A / cnorm: lattice row vectors (T = n . A) and the column norms of
//          A^{-1} -- images are ENUMERATED per primitive pair as the
//          fractional-coordinate subbox |n_i - f_i| <= rc * cnorm_i
//          around f = (P - Q) A^{-1} (exact: |x - nA| < rc implies
//          each |f_i - n_i| <= rc ||col_i A^{-1}||), so the work per
//          primitive pair is O(surviving images), independent of the
//          global image-list length.
//   out: base pointer ALREADY offset by i0*s0 + j0*s1; strides
//        s0 (i), s1 (j), s2 (k); l stride 1.
void erfc_eri_rows(int64_t l12, int64_t nc1, int64_t nc2, int64_t np12,
                   const double* pc12, const double* E12,
                   const double* Pm, double Pr,
                   int64_t nkp, const int64_t* kmeta,
                   const double* kgeom, const double* pc34,
                   const double* E34,
                   const double* A, const double* Ainv,
                   const double* cnorm,
                   double omega, double lntol, double rcut_sh,
                   int64_t s0, int64_t s1, int64_t s2,
                   double* out) {
    const double w2 = omega * omega;
    const double sql = std::sqrt(lntol);
    const int h12 = (int)((l12 + 1) * (l12 + 1) * (l12 + 1));
    const int nc12 = (int)(nc1 * nc2);
    const double TWO_PI_2_5 = 2.0 * 17.493418327624862;  // 2 pi^2.5
    (void)Pm; (void)Pr; (void)kgeom; (void)rcut_sh;

    static thread_local double R2[125 * 125]; // h12 x h34, l12,l34 <= 4
    static thread_local double tm[225 * 125]; // nc12 x h34 (l<=4 cart)
    double Rsum[LERI + 1][LERI + 1][LERI + 1];
    double Rtmp[LERI + 1][LERI + 1][LERI + 1];
    double Fn[NERI + 1];

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
        const int lsum = (int)(l12 + l34);
        const int nmax = 3 * lsum;
        const int n1 = (int)l12 + 1, n3 = (int)l34 + 1;

        for (int64_t a = 0; a < np12; ++a) {
            const double p = pc12[6 * a], cA = pc12[6 * a + 1];
            const double Px = pc12[6 * a + 2], Py = pc12[6 * a + 3],
                         Pz = pc12[6 * a + 4];
            const double eA = pc12[6 * a + 5];
            for (int64_t b = p_off; b < p_off + p_len; ++b) {
                const double q = pc34[6 * b], cB = pc34[6 * b + 1];
                const double ex = Px - pc34[6 * b + 2];
                const double ey = Py - pc34[6 * b + 3];
                const double ez = Pz - pc34[6 * b + 4];
                const double eB = pc34[6 * b + 5];
                const double alpha = p * q / (p + q);
                const double theta = alpha * w2 / (alpha + w2);
                const double sc = std::sqrt(theta / alpha);
                const double fac0 = TWO_PI_2_5
                    / (p * q * std::sqrt(p + q));
                // magnitude-aware range: the SR kernel decays as
                // exp(-theta r^2)/r and the whole term carries the
                // E-table magnitudes, so images beyond
                //   Amag exp(-theta r^2) < prec  (prec = e^{-lntol})
                // are dropped (mirrors the kernel-only bound
                // sqrt(lntol)/w + sqrt(lntol/alpha) but collapses for
                // weak overlap pairs).
                const double Amag = std::fabs(cA * cB) * eA * eB * fac0;
                const double lAm = std::log(Amag) + lntol;
                if (lAm <= 0.0) continue;
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
                            for (int u1 = 0; u1 <= lsum; ++u1)
                                for (int v1 = 0; v1 <= lsum; ++v1)
                                    Rsum[t1][u1][v1] = 0.0;
                    ++n_in;
                    if (lsum == 0) {  // s quadruple: F0 only
                        double fa, ft;
                        boys(0, alpha * r2, &fa);
                        boys(0, theta * r2, &ft);
                        Rsum[0][0][0] += fa - sc * ft;
                        continue;
                    }
                    boys(nmax, alpha * r2, Fn);
                    r_table_point<double, LERI>(lsum, alpha, px, py, pz,
                                                Fn, Rtmp);
                    for (int t1 = 0; t1 <= lsum; ++t1)
                        for (int u1 = 0; u1 <= lsum; ++u1)
                            for (int v1 = 0; v1 <= lsum; ++v1)
                                Rsum[t1][u1][v1] += Rtmp[t1][u1][v1];
                    boys(nmax, theta * r2, Fn);
                    r_table_point<double, LERI>(lsum, theta, px, py, pz,
                                                Fn, Rtmp);
                    for (int t1 = 0; t1 <= lsum; ++t1)
                        for (int u1 = 0; u1 <= lsum; ++u1)
                            for (int v1 = 0; v1 <= lsum; ++v1)
                                Rsum[t1][u1][v1] -= sc * Rtmp[t1][u1][v1];
                }
                if (n_in == 0) continue;
                const double fac = cA * cB * TWO_PI_2_5
                    / (p * q * std::sqrt(p + q));
                // R2[(t,u,v), (tau,nu,phi)] with ket parity
                int hh = 0;
                for (int t1 = 0; t1 < n1; ++t1)
                    for (int u1 = 0; u1 < n1; ++u1)
                        for (int v1 = 0; v1 < n1; ++v1) {
                            double* row = R2 + (int64_t)hh * h34;
                            int gg = 0;
                            for (int t2 = 0; t2 < n3; ++t2)
                                for (int u2 = 0; u2 < n3; ++u2)
                                    for (int v2 = 0; v2 < n3; ++v2, ++gg) {
                                        const double s =
                                            ((t2 + u2 + v2) & 1) ? -1.0
                                                                 : 1.0;
                                        row[gg] = s *
                                            Rsum[t1 + t2][u1 + u2]
                                                [v1 + v2];
                                    }
                            ++hh;
                        }
                // tm = E12[a] (nc12 x h12) . R2 (h12 x h34)
                const double* Ea = E12 + (int64_t)a * nc12 * h12;
                for (int c = 0; c < nc12; ++c) {
                    double* tr = tm + (int64_t)c * h34;
                    for (int g = 0; g < h34; ++g) tr[g] = 0.0;
                    const double* er = Ea + (int64_t)c * h12;
                    for (int h = 0; h < h12; ++h) {
                        const double e = er[h];
                        if (e == 0.0) continue;
                        const double* rr = R2 + (int64_t)h * h34;
                        for (int g = 0; g < h34; ++g) tr[g] += e * rr[g];
                    }
                }
                // out[ij, kl] += fac * tm . E34[b]^T
                const double* Eb = E34 + e_off
                    + (b - p_off) * (int64_t)nc34 * h34;
                for (int c = 0; c < nc12; ++c) {
                    const int i = c / (int)nc2, j = c % (int)nc2;
                    double* ob = out + i * s0 + j * s1 + out_off;
                    double* obT = (out_off_T >= 0)
                        ? out + i * s0 + j * s1 + out_off_T : nullptr;
                    const double* tr = tm + (int64_t)c * h34;
                    for (int d = 0; d < nc34; ++d) {
                        const double* eb = Eb + (int64_t)d * h34;
                        double acc = 0.0;
                        for (int g = 0; g < h34; ++g)
                            acc += tr[g] * eb[g];
                        const int k = d / (int)nc4, l = d % (int)nc4;
                        const double v = fac * acc;
                        ob[k * s2 + l] += v;
                        if (obT) obT[l * s2 + k] += v;
                    }
                }
            }
        }
    }
}

}  // extern "C"
