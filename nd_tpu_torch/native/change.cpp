// Omnibus change detection reference kernel (CPU, C++17 + OpenMP): the
// port's copy of the JAX package's nd_tpu/_native/change.cpp.
//
// Implements the Conradsen et al. (2016) complex-Wishart omnibus test
// with the iterative change-point scan of nd_tpu_torch/ops/change.py.
// The chi-square CDF is computed natively via the regularized lower
// incomplete gamma function (series + continued fraction), so there is
// no GSL dependency. A host-side oracle and the single-core CPU
// yardstick; nothing on a path of the port calls it. Built with the
// host compiler at first use (nd_tpu_torch/native).

#include <cmath>
#include <cstdint>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Regularized lower incomplete gamma P(a, x).
double gammp(double a, double x) {
    if (x < 0.0 || a <= 0.0) return std::numeric_limits<double>::quiet_NaN();
    if (x == 0.0) return 0.0;
    const double gln = std::lgamma(a);
    if (x < a + 1.0) {
        // series representation
        double ap = a;
        double sum = 1.0 / a;
        double del = sum;
        for (int i = 0; i < 500; ++i) {
            ap += 1.0;
            del *= x / ap;
            sum += del;
            if (std::fabs(del) < std::fabs(sum) * 1e-16) break;
        }
        return sum * std::exp(-x + a * std::log(x) - gln);
    }
    // continued fraction for Q(a, x)
    const double FPMIN = std::numeric_limits<double>::min() / 1e-30;
    double b = x + 1.0 - a;
    double c = 1.0 / FPMIN;
    double d = 1.0 / b;
    double h = d;
    for (int i = 1; i <= 500; ++i) {
        const double an = -1.0 * i * (i - a);
        b += 2.0;
        d = an * d + b;
        if (std::fabs(d) < FPMIN) d = FPMIN;
        c = b + an / c;
        if (std::fabs(c) < FPMIN) c = FPMIN;
        d = 1.0 / d;
        const double del = d * c;
        h *= del;
        if (std::fabs(del - 1.0) < 1e-16) break;
    }
    const double q = std::exp(-x + a * std::log(x) - gln) * h;
    return 1.0 - q;
}

inline double chi2_cdf(double x, double df) {
    if (std::isnan(x)) return std::numeric_limits<double>::quiet_NaN();
    if (x <= 0.0) return 0.0;
    // +inf statistic (exactly singular per-step determinant): CDF is
    // 1 — the continued fraction would produce NaN and silently drop
    // the detection (scipy chi2.cdf(inf)=1; the kernels' threshold
    // compare flags it too)
    if (std::isinf(x)) return 1.0;
    return gammp(df / 2.0, x / 2.0);
}

constexpr double P = 2.0;  // dual-pol

// Omnibus probability over ts[l:l+j] given per-pixel channel arrays.
// ts layout: (k, 4) row-major.
double omnibus_prob(const double* ts, int64_t l, int64_t j, double n) {
    const double k = static_cast<double>(j);
    double c11 = 0, c12r = 0, c12i = 0, c22 = 0;
    double logdet = 0;
    int neg = 0;
    for (int64_t i = l; i < l + j; ++i) {
        const double a = ts[4 * i + 0];
        const double br = ts[4 * i + 1];
        const double bi = ts[4 * i + 2];
        const double d = ts[4 * i + 3];
        const double det = a * d - br * br - bi * bi;
        if (det < 0) ++neg;
        logdet += std::log(std::fabs(det));
        c11 += a; c12r += br; c12i += bi; c22 += d;
    }
    const double det_of_sum = c11 * c22 - c12r * c12r - c12i * c12i;
    const double log_prod = (neg % 2 == 0)
        ? logdet : std::numeric_limits<double>::quiet_NaN();
    const double logQ = n * (P * k * std::log(k) + log_prod
                             - k * std::log(det_of_sum));
    const double rho = 1.0 - (2.0 * P * P - 1.0) / (6.0 * (k - 1.0) * P)
        * (k / n - 1.0 / (n * k));
    const double z = -2.0 * rho * logQ;
    const double f = (k - 1.0) * P * P;
    const double omega2 = P * P * (P * P - 1.0) / (24.0 * rho * rho)
        * (k / (n * n) - 1.0 / ((n * k) * (n * k)))
        - P * P * (k - 1.0) / 4.0 * (1.0 - 1.0 / rho)
        * (1.0 - 1.0 / rho);
    const double p1 = chi2_cdf(z, f);
    const double p2 = chi2_cdf(z, f + 4.0);
    return p1 + omega2 * (p2 - p1);
}

void single_pixel(const double* ts, uint8_t* result, int64_t k,
                  double alpha, double n) {
    int64_t l = 0;
    while (true) {
        if (!(omnibus_prob(ts, l, k - l, n) > alpha)) break;
        int64_t r = -1;
        for (int64_t j = 2; j <= k - l; ++j) {
            r = j - 1;
            if (omnibus_prob(ts, l, j, n) > alpha) {
                result[l + r] = 1;
                break;
            }
        }
        if (r < 0) break;
        l += r;
        if (l >= k - 1) break;
    }
}

template <typename T>
void change_impl(const T* values, uint8_t* out,
                 int64_t ny, int64_t nx, int64_t k,
                 double alpha, double n, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t i = 0; i < ny; ++i) {
        double* ts = new double[k * 4];
        for (int64_t j = 0; j < nx; ++j) {
            const T* src = values + (i * nx + j) * k * 4;
            for (int64_t t = 0; t < k * 4; ++t)
                ts[t] = static_cast<double>(src[t]);
            uint8_t* res = out + (i * nx + j) * k;
            for (int64_t t = 0; t < k; ++t) res[t] = 0;
            single_pixel(ts, res, k, alpha, n);
        }
        delete[] ts;
    }
}

}  // namespace

extern "C" {

void nd_change_f32(const float* values, uint8_t* out,
                   int64_t ny, int64_t nx, int64_t k,
                   double alpha, double n, int nthreads) {
    change_impl<float>(values, out, ny, nx, k, alpha, n, nthreads);
}

void nd_change_f64(const double* values, uint8_t* out,
                   int64_t ny, int64_t nx, int64_t k,
                   double alpha, double n, int nthreads) {
    change_impl<double>(values, out, ny, nx, k, alpha, n, nthreads);
}

}  // extern "C"
