// Long-series complex-Wishart omnibus change-point scan with bit-packed
// flags and decision margins, one thread per pixel, no restart rounds.
//
// Replaces: nd_tpu/ops/change_scan_pallas.py change_detection_scan
// (_scan_kernel). Input is a contiguous (npix, k, 4) float32 series of
// [C11, C12.re, C12.im, C22] with 3 <= k <= 256; outputs are the flag
// planes (bit t%31 of int32 plane t//31, planes of npix) and each
// pixel's smallest decision margin net of the f32 error bound (threshold
// fit error included). `rel_b` is a (k, npix) float32 scratch from the
// wrapper.
//
// The restart chain of the omnibus scan advances monotonically in time,
// so three O(k) passes replace the round kernel's O(rounds * k) work:
// A builds the ungated tentative chain (running sums reset at each hit,
// polynomial thresholds in sqrt(j)), B evaluates every anchor's global
// test [t, k-1] from suffix sums (exact f64 thresholds cast to f32 at the
// compare), C commits A's flags while the global tests of the anchors
// reached so far all reject.
//
// Bound on the H100: arithmetic (two determinants, two logs, one sqrt and
// a degree <= 14 Horner per step). The TPU kernel kept six (k, ty, tx)
// planes in VMEM; here a thread runs pass B first, keeping the global
// hits as bits in registers (k <= 256: 8 words) and B's margins in the
// t-major scratch (coalesced: consecutive threads, consecutive pixels),
// then fuses A and C in one forward loop, since C at step t needs only
// A's and B's values at t. The per-step log|det| and conditioning are
// recomputed from the series in each pass instead of being stored.
//
// Numerics: each statistic's arithmetic is the TPU kernel's, in the same
// order ((det_sum * invj) * invj, Horner highest order first); built with
// -fmad=false and IEEE sqrtf and division, so every step rounds as the
// host replica (_sim_f32) behind the fit-error bound assumes. Minimum and
// maximum propagate NaN (jnp.minimum semantics), so a NaN margin stays
// NaN and its pixel is a suspect of the exact mode.

#include <cuda_runtime.h>
#include <cmath>

#include "mlog.cuh"

namespace {

constexpr int kMaxK = 256;
constexpr int kMaxCoefs = 16;
constexpr int kMaxSmall = 4;
constexpr int kWords = (kMaxK + 31) / 32;
constexpr int kPlanes = (kMaxK + 30) / 31;

struct ScanTables {
  float coef[kMaxCoefs];      // F2 polynomial in z, lowest order first
  float f2_small[kMaxSmall];  // exact F2 for j = 2..5
  float s_small[kMaxSmall];   // exact margin scale for j = 2..5
  float cg[kMaxK + 1];        // global-test threshold per window length
  float sg[kMaxK + 1];        // global-test margin scale per length
  float f2_err, f2_infl, za, zb, nf;
  int ncoef, nsmall;
};

// NaN-propagating min / max (jnp.minimum / jnp.maximum).
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

struct Elem {
  float x11, x12r, x12i, x22, logdet, neg, cond;
};

// One time step: the channels, log|det| and the conditioning |csd| with
// its sign bit (csd = -cond where det < 0), as the TPU kernel stores them.
__device__ __forceinline__ Elem load_elem(const float* ser, int t) {
  const float4 v = reinterpret_cast<const float4*>(ser)[t];
  Elem e;
  e.x11 = v.x;
  e.x12r = v.y;
  e.x12i = v.z;
  e.x22 = v.w;
  const float det = v.x * v.w - v.y * v.y - v.z * v.z;
  const float prods = fabsf(v.x * v.w) + v.y * v.y + v.z * v.z;
  e.logdet = mlog(fabsf(det));
  const float cond = nmin(prods / nmax(fabsf(det), 1e-37f), 1e18f);
  const float csd = det < 0.f ? -cond : cond;
  e.cond = fabsf(csd);
  e.neg = csd < 0.f ? 1.f : 0.f;
  return e;
}

struct Sums {
  float a11, a12r, a12i, a22, alog, aneg, acond;
  __device__ __forceinline__ void set(const Elem& e) {
    a11 = e.x11; a12r = e.x12r; a12i = e.x12i; a22 = e.x22;
    alog = e.logdet; aneg = e.neg; acond = e.cond;
  }
  __device__ __forceinline__ Sums plus(const Elem& e) const {
    Sums s;
    s.a11 = a11 + e.x11; s.a12r = a12r + e.x12r; s.a12i = a12i + e.x12i;
    s.a22 = a22 + e.x22; s.alog = alog + e.logdet; s.aneg = aneg + e.neg;
    s.acond = acond + e.cond;
    return s;
  }
};

// Relative margin of the window's decision s < c: (|s - c| - serr) * scale,
// or -inf / +inf for a non-finite statistic (-inf where the sign of a
// determinant is within rounding of zero).
__device__ __forceinline__ float window_rel(const Sums& a, float j,
                                            bool averaged, float nf, float c,
                                            float scale, bool* hit) {
  const float kU64 = (float)(64 * 1.2e-7);
  const float kInvU64 = (float)(1.0 / (64 * 1.2e-7));
  const float kLogErr = (float)1e-5;
  const float det_sum = a.a11 * a.a22 - a.a12r * a.a12r - a.a12i * a.a12i;
  const float det_prods =
      fabsf(a.a11 * a.a22) + a.a12r * a.a12r + a.a12i * a.a12i;
  const bool odd = (a.aneg - 2.0f * floorf(a.aneg * 0.5f)) > 0.5f;
  const float log_prod = odd ? NAN : a.alog;
  float s;
  if (averaged) {
    const float invj = 1.0f / j;
    s = nf * log_prod - (nf * j) * mlog(det_sum * invj * invj);
  } else {
    s = nf * log_prod - (nf * j) * mlog(det_sum);
  }
  *hit = s < c;
  if (!isfinite(s)) {
    const bool sign_unc = a.acond > kInvU64 || fabsf(det_sum) < kU64 * det_prods;
    return sign_unc ? -INFINITY : INFINITY;
  }
  const float cond_sum = nmin(det_prods / nmax(fabsf(det_sum), 1e-37f), 1e18f);
  const float serr =
      nf * ((a.acond + j * cond_sum) * kU64 + (j + 1.0f) * kLogErr);
  return (fabsf(s - c) - serr) * scale;
}

__global__ void omnibus_scan_kernel(const float* __restrict__ values,
                                    int* __restrict__ packed,
                                    float* __restrict__ margin,
                                    float* __restrict__ rel_b, long long npix,
                                    int k, ScanTables tab) {
  const int nplanes = (k + 30) / 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       pix < npix; pix += stride) {
    const float* ser = values + pix * (long long)k * 4;

    // ---- pass B: global test of every anchor t (backward) ----
    unsigned ghit[kWords];
    for (int w = 0; w < kWords; ++w) ghit[w] = 0u;
    rel_b[(long long)(k - 1) * npix + pix] = INFINITY;
    Sums run;
    run.set(load_elem(ser, k - 1));
    for (int t = k - 2; t >= 0; --t) {
      run = run.plus(load_elem(ser, t));
      const int jg = k - t;
      const float cg = tab.cg[jg];
      float rel = INFINITY;
      if (isfinite(cg)) {           // -inf: the test never rejects
        bool hit;
        rel = window_rel(run, (float)jg, false, tab.nf, cg, tab.sg[jg], &hit);
        if (hit) ghit[t >> 5] |= 1u << (t & 31);
      }
      rel_b[(long long)t * npix + pix] = rel;
    }

    // ---- passes A and C: tentative chain, committed under the gate ----
    int planes[kPlanes];
    for (int p = 0; p < kPlanes; ++p) planes[p] = 0;
    float mrg = rel_b[pix];              // anchor 0's global test
    bool alive = (ghit[0] & 1u) != 0u;
    run.set(load_elem(ser, 0));
    float rj = 1.0f;
    for (int t = 1; t < k; ++t) {
      const Elem e = load_elem(ser, t);
      const Sums a = run.plus(e);
      const float j = rj + 1.0f;
      const float z = sqrtf(j) * tab.za + tab.zb;
      float f2v = tab.coef[tab.ncoef - 1];
      for (int i = tab.ncoef - 2; i >= 0; --i) f2v = f2v * z + tab.coef[i];
      float scale = 1.0f / (f2v * tab.f2_infl);
      for (int i = 0; i < tab.nsmall; ++i) {
        if (j == (float)(i + 2)) {
          f2v = tab.f2_small[i];
          scale = tab.s_small[i];
        }
      }
      bool hit;
      const float rel_a =
          window_rel(a, j, true, tab.nf, -f2v, scale, &hit) - tab.f2_err;
      if (alive) {
        mrg = nmin(mrg, rel_a);
        if (hit) {
          planes[t / 31] |= 1 << (t % 31);
          mrg = nmin(mrg, rel_b[(long long)t * npix + pix]);
          alive = ((ghit[t >> 5] >> (t & 31)) & 1u) != 0u;
        }
      }
      if (hit) {
        run.set(e);
        rj = 1.0f;
      } else {
        run = a;
        rj = j;
      }
    }
    for (int p = 0; p < nplanes; ++p) packed[(long long)p * npix + pix] = planes[p];
    margin[pix] = mrg;
  }
}

}  // namespace

extern "C" {

int nd_omnibus_scan_max_k() { return kMaxK; }

int nd_omnibus_scan_f32(const void* values, void* packed, void* margin,
                        void* rel_b, long long npix, int k, const double* coef,
                        int ncoef, const double* f2_small,
                        const double* s_small, int nsmall, const double* cg,
                        const double* sg, double f2_err, double f2_infl,
                        double za, double zb, double nf, void* stream) {
  if (k < 3 || k > kMaxK || ncoef < 1 || ncoef > kMaxCoefs || nsmall < 0 ||
      nsmall > kMaxSmall)
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  ScanTables tab;
  for (int i = 0; i < kMaxCoefs; ++i) tab.coef[i] = i < ncoef ? (float)coef[i] : 0.f;
  for (int i = 0; i < kMaxSmall; ++i) {
    tab.f2_small[i] = i < nsmall ? (float)f2_small[i] : 0.f;
    tab.s_small[i] = i < nsmall ? (float)s_small[i] : 0.f;
  }
  for (int j = 0; j <= kMaxK; ++j) {
    tab.cg[j] = j <= k ? (float)cg[j] : -INFINITY;
    tab.sg[j] = j <= k ? (float)sg[j] : 0.f;
  }
  tab.f2_err = (float)f2_err;
  tab.f2_infl = (float)f2_infl;
  tab.za = (float)za;
  tab.zb = (float)zb;
  tab.nf = (float)nf;
  tab.ncoef = ncoef;
  tab.nsmall = nsmall;
  const int threads = 128;
  long long blocks = (npix + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  omnibus_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(values), static_cast<int*>(packed),
      static_cast<float*>(margin), static_cast<float*>(rel_b), npix, k, tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
