// Native s-Gaussian integral core (copy of the JAX package's
// libdmet_preview_tpu/ints/_gto_core.cpp): contracted s-shell two-electron
// repulsion integrals over the Boys F0 kernel, plain C ABI consumed through
// ctypes.
//
// Built at first use by ints/native.py:
//   g++ -O3 -shared -fPIC -x c++ -o build/native/_gto_core.<hash>.so _gto_core.cpp

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const double PI = 3.14159265358979323846;

inline double boys0(double x) {
    // F0(x) = 0.5 sqrt(pi/x) erf(sqrt(x)); series near 0
    if (x < 1e-12) return 1.0 - x / 3.0;
    double s = std::sqrt(x);
    return 0.5 * std::sqrt(PI / x) * std::erf(s);
}

struct PairTab {
    // flattened primitive-pair quantities per AO pair (i >= j)
    std::vector<double> p;    // exponents sum
    std::vector<double> cK;   // contraction * gaussian product prefactor
    std::vector<double> P;    // product centers, 3 per entry
    std::vector<int64_t> off; // start offset per pair
    std::vector<int64_t> len; // entries per pair
};

}  // namespace

extern "C" {

// nao: number of contracted s AOs
// nprim[i]: primitives in AO i; exps/cofs: concatenated primitive data
// cens: (nao, 3) centers; out: (nao^4) chemist ERI (row-major)
void eri_s_shells(int64_t nao, const int64_t* nprim, const double* exps,
                  const double* cofs, const double* cens, double* out) {
    std::vector<int64_t> pstart(nao + 1, 0);
    for (int64_t i = 0; i < nao; ++i) pstart[i + 1] = pstart[i] + nprim[i];

    // pair table over i >= j
    int64_t npair = nao * (nao + 1) / 2;
    PairTab tab;
    tab.off.resize(npair);
    tab.len.resize(npair);
    {
        int64_t total = 0;
        int64_t idx = 0;
        for (int64_t i = 0; i < nao; ++i)
            for (int64_t j = 0; j <= i; ++j, ++idx) {
                tab.off[idx] = total;
                tab.len[idx] = nprim[i] * nprim[j];
                total += tab.len[idx];
            }
        tab.p.resize(total);
        tab.cK.resize(total);
        tab.P.resize(total * 3);
    }
    {
        int64_t idx = 0;
        for (int64_t i = 0; i < nao; ++i) {
            const double* A = cens + 3 * i;
            for (int64_t j = 0; j <= i; ++j, ++idx) {
                const double* B = cens + 3 * j;
                double AB2 = 0.0;
                for (int d = 0; d < 3; ++d)
                    AB2 += (A[d] - B[d]) * (A[d] - B[d]);
                int64_t o = tab.off[idx];
                for (int64_t u = 0; u < nprim[i]; ++u) {
                    double a = exps[pstart[i] + u];
                    double ca = cofs[pstart[i] + u];
                    for (int64_t v = 0; v < nprim[j]; ++v, ++o) {
                        double b = exps[pstart[j] + v];
                        double cb = cofs[pstart[j] + v];
                        double pp = a + b;
                        tab.p[o] = pp;
                        tab.cK[o] = ca * cb * std::exp(-(a * b / pp) * AB2);
                        for (int d = 0; d < 3; ++d)
                            tab.P[3 * o + d] = (a * A[d] + b * B[d]) / pp;
                    }
                }
            }
        }
    }

    auto pair_index = [](int64_t i, int64_t j) {  // i >= j
        return i * (i + 1) / 2 + j;
    };

    // quartets with 8-fold symmetry: (ij) >= (kl) in pair-index order
    for (int64_t i = 0; i < nao; ++i)
        for (int64_t j = 0; j <= i; ++j) {
            int64_t ij = pair_index(i, j);
            for (int64_t k = 0; k < nao; ++k)
                for (int64_t l = 0; l <= k; ++l) {
                    int64_t kl = pair_index(k, l);
                    if (kl > ij) continue;
                    double val = 0.0;
                    int64_t o1 = tab.off[ij], n1 = tab.len[ij];
                    int64_t o2 = tab.off[kl], n2 = tab.len[kl];
                    for (int64_t u = 0; u < n1; ++u) {
                        double p = tab.p[o1 + u];
                        double c1 = tab.cK[o1 + u];
                        const double* P = &tab.P[3 * (o1 + u)];
                        for (int64_t v = 0; v < n2; ++v) {
                            double q = tab.p[o2 + v];
                            double c2 = tab.cK[o2 + v];
                            const double* Q = &tab.P[3 * (o2 + v)];
                            double PQ2 = 0.0;
                            for (int d = 0; d < 3; ++d)
                                PQ2 += (P[d] - Q[d]) * (P[d] - Q[d]);
                            double denom = p + q;
                            val += c1 * c2 * 2.0 * std::pow(PI, 2.5)
                                / (p * q * std::sqrt(denom))
                                * boys0(p * q / denom * PQ2);
                        }
                    }
                    // scatter the 8 symmetry images
                    int64_t idx4[8][4] = {
                        {i, j, k, l}, {j, i, k, l}, {i, j, l, k},
                        {j, i, l, k}, {k, l, i, j}, {l, k, i, j},
                        {k, l, j, i}, {l, k, j, i}};
                    for (auto& q4 : idx4) {
                        out[((q4[0] * nao + q4[1]) * nao + q4[2]) * nao
                            + q4[3]] = val;
                    }
                }
        }
}

}  // extern "C"
