// Non-local means reference kernel (CPU, C++17 + OpenMP): the port's
// copy of the JAX package's nd_tpu/_native/nlmeans.cpp.
//
// Implements the published NLMeans algorithm (Buades et al. 2011) with
// the conventions of nd_tpu_torch/ops/nlmeans.py: odd-reflect boundary
// indexing, weight exp(-max(dsq - 2 sigma^2, 0)/h^2), self-weight = max
// weight or the n_eff effective-sample-size solution. A host-side
// oracle and the single-core CPU yardstick; OpenMP parallelizes over
// the leading dimension for multi-core runs. Nothing on a path of the
// port calls it. Built with the host compiler at first use
// (nd_tpu_torch/native).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t reflect(int64_t i, int64_t n) {
    if (i < 0) return -i;
    if (i >= n) return 2 * n - 2 - i;
    return i;
}

template <typename T>
void nlmeans_impl(const T* arr, T* out,
                  int64_t d0, int64_t d1, int64_t d2, int64_t nv,
                  int64_t r0, int64_t r1, int64_t r2,
                  int64_t f0, int64_t f1, int64_t f2,
                  double sigma, double h, double n_eff,
                  int nthreads) {
    const double dsq_norm = static_cast<double>(
        nv * (2 * f0 + 1) * (2 * f1 + 1) * (2 * f2 + 1));
    const double two_sigma2 = 2.0 * sigma * sigma;
    const double inv_h2 = 1.0 / (h * h);
    const int64_t s2 = nv;          // stride of d2
    const int64_t s1 = d2 * s2;     // stride of d1
    const int64_t s0 = d1 * s1;     // stride of d0

#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (int64_t p0 = 0; p0 < d0; ++p0) {
        std::vector<double> wsum(nv);
        for (int64_t p1 = 0; p1 < d1; ++p1) {
            for (int64_t p2 = 0; p2 < d2; ++p2) {
                double total_w = 0.0, total_sq_w = 0.0, max_w = 0.0;
                std::fill(wsum.begin(), wsum.end(), 0.0);

                for (int64_t q0 = p0 - r0; q0 <= p0 + r0; ++q0)
                for (int64_t q1 = p1 - r1; q1 <= p1 + r1; ++q1)
                for (int64_t q2 = p2 - r2; q2 <= p2 + r2; ++q2) {
                    if (q0 == p0 && q1 == p1 && q2 == p2) continue;
                    double dsq = 0.0;
                    for (int64_t e0 = -f0; e0 <= f0; ++e0)
                    for (int64_t e1 = -f1; e1 <= f1; ++e1)
                    for (int64_t e2 = -f2; e2 <= f2; ++e2) {
                        const T* a = arr
                            + reflect(p0 + e0, d0) * s0
                            + reflect(p1 + e1, d1) * s1
                            + reflect(p2 + e2, d2) * s2;
                        const T* b = arr
                            + reflect(q0 + e0, d0) * s0
                            + reflect(q1 + e1, d1) * s1
                            + reflect(q2 + e2, d2) * s2;
                        for (int64_t v = 0; v < nv; ++v) {
                            const double diff =
                                static_cast<double>(a[v])
                                - static_cast<double>(b[v]);
                            dsq += diff * diff;
                        }
                    }
                    dsq /= dsq_norm;
                    const double w = std::exp(
                        -std::max(dsq - two_sigma2, 0.0) * inv_h2);
                    total_w += w;
                    total_sq_w += w * w;
                    max_w = std::max(max_w, w);
                    const T* qv = arr + reflect(q0, d0) * s0
                        + reflect(q1, d1) * s1 + reflect(q2, d2) * s2;
                    for (int64_t v = 0; v < nv; ++v)
                        wsum[v] += w * static_cast<double>(qv[v]);
                }

                double w_self;
                if (n_eff < 0) {
                    w_self = (max_w == 0.0) ? 1.0 : max_w;
                } else {
                    const double rt = std::sqrt(
                        n_eff * total_w * total_w
                        - n_eff * n_eff * total_sq_w
                        + n_eff * total_sq_w);
                    w_self = (total_w + rt) / (n_eff - 1.0);
                }
                total_w += w_self;
                const T* pv = arr + p0 * s0 + p1 * s1 + p2 * s2;
                T* ov = out + p0 * s0 + p1 * s1 + p2 * s2;
                for (int64_t v = 0; v < nv; ++v) {
                    ov[v] = static_cast<T>(
                        (wsum[v] + w_self
                         * static_cast<double>(pv[v])) / total_w);
                }
            }
        }
    }
}

}  // namespace

extern "C" {

void nd_nlmeans_f32(const float* arr, float* out,
                    int64_t d0, int64_t d1, int64_t d2, int64_t nv,
                    int64_t r0, int64_t r1, int64_t r2,
                    int64_t f0, int64_t f1, int64_t f2,
                    double sigma, double h, double n_eff,
                    int nthreads) {
    nlmeans_impl<float>(arr, out, d0, d1, d2, nv, r0, r1, r2,
                        f0, f1, f2, sigma, h, n_eff, nthreads);
}

void nd_nlmeans_f64(const double* arr, double* out,
                    int64_t d0, int64_t d1, int64_t d2, int64_t nv,
                    int64_t r0, int64_t r1, int64_t r2,
                    int64_t f0, int64_t f1, int64_t f2,
                    double sigma, double h, double n_eff,
                    int nthreads) {
    nlmeans_impl<double>(arr, out, d0, d1, d2, nv, r0, r1, r2,
                         f0, f1, f2, sigma, h, n_eff, nthreads);
}

}  // extern "C"
