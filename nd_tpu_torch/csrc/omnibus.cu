// Fast (float32) complex-Wishart omnibus change-point scan, one thread per
// pixel, with bit-packed flags and decision margins.
//
// Replaces: nd_tpu/ops/change_pallas.py change_detection_pallas (_kernel,
// _mlog). Input is a contiguous (npix, k, 4) float32 series of
// [C11, C12.re, C12.im, C22]; outputs are the flag planes (bit t%31 of
// int32 plane t//31, planes of npix) and, when `margin` is not null, each
// pixel's smallest decision margin net of the f32 error bound.
//
// Bound on the H100: arithmetic. Device memory sees 16*k bytes in and
// 4*ceil(k/31) (+4) bytes out per pixel; each restart round costs O(k)
// work per pixel (running sums, two determinants, one or two logs, the
// margin bound). The TPU kernel unrolled the rounds over masked vector
// tiles, so every pixel paid every round. Here a thread runs its own
// pixel's scan and stops when the pixel is done, so a pixel pays only
// the rounds it uses; the per-step quantities are recomputed from the
// series (L1-resident) instead of being stored, which keeps the thread
// in registers.
//
// Numerics: the same round scan as the TPU kernel: f32 running sums from
// the anchor l, the folded per-length immediates C(j) and S(j) computed
// on the host in float64, first hit by minimum, and the max_rounds cap
// with still-active pixels given margin -inf. _mlog is ported as
// mlog() in mlog.cuh, so the calibrated 1e-5-per-log and 64*1.2e-7
// conditioning terms of the margin bound keep their meaning. FMA policy:
// built with -fmad=false, so every product and sum rounds separately, as
// in the plain PyTorch version and in the TPU kernel the bound was
// calibrated on.

#include <cuda_runtime.h>
#include <cmath>

#include "mlog.cuh"

namespace {

constexpr int kMaxK = 256;

struct Tables {
  float c[kMaxK + 1];  // folded thresholds C(j); -inf: never hits
  float s[kMaxK + 1];  // margin scale S(j)
};

__global__ void omnibus_kernel(const float* __restrict__ values,
                               int* __restrict__ packed,
                               float* __restrict__ margin, long long npix,
                               int k, Tables tab, float nf, int rounds) {
  const float kU64 = (float)(64 * 1.2e-7);
  const float kLogErr = 1e-5f;
  const int nplanes = (k + 30) / 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       pix < npix; pix += stride) {
    const float* ser = values + pix * (long long)k * 4;
    for (int pp = 0; pp < nplanes; ++pp) packed[pp * npix + pix] = 0;
    float mrg = INFINITY;
    int l = 0;
    bool active = k > 1;
    for (int round = 0; round < rounds && active; ++round) {
      float s11 = 0.f, s12r = 0.f, s12i = 0.f, s22 = 0.f;
      float sld = 0.f, sneg = 0.f, scond = 0.f, sunc = 0.f;
      float round_margin = INFINITY;
      int t_first = -1;
      bool hit_last = false;
      for (int t = l; t < k; ++t) {
        const float c11 = ser[4 * t], c12r = ser[4 * t + 1];
        const float c12i = ser[4 * t + 2], c22 = ser[4 * t + 3];
        const float det = c11 * c22 - c12r * c12r - c12i * c12i;
        s11 = s11 + c11;
        s12r = s12r + c12r;
        s12i = s12i + c12i;
        s22 = s22 + c22;
        sld = sld + mlog(fabsf(det));
        sneg = sneg + (det < 0.f ? 1.f : 0.f);
        if (margin) {
          const float prods = fabsf(c11 * c22) + c12r * c12r + c12i * c12i;
          const float cond = fminf(prods / fmaxf(fabsf(det), 1e-37f), 1e18f);
          scond = scond + cond;
          sunc = sunc + (fabsf(det) < kU64 * prods ? 1.f : 0.f);
        }
        if (t < l + 1) continue;
        const float jt = (float)(t - l + 1);
        const float dos = s11 * s22 - s12r * s12r - s12i * s12i;
        const bool odd_neg = (sneg - 2.0f * floorf(sneg * 0.5f)) > 0.5f;
        const float log_prod = odd_neg ? NAN : sld;
        const float s = nf * log_prod - (nf * jt) * mlog(dos);
        const float c = tab.c[t - l + 1];
        const bool hit = s < c;
        if (hit && t_first < 0) t_first = t;
        if (t == k - 1) hit_last = hit;
        if (margin && isfinite(c)) {
          const float det_prods = fabsf(s11 * s22) + s12r * s12r
                                  + s12i * s12i;
          const float cond_sum =
              fminf(det_prods / fmaxf(fabsf(dos), 1e-37f), 1e18f);
          const float serr = nf * ((scond + jt * cond_sum) * kU64
                                   + (jt + 1.0f) * kLogErr);
          const bool sign_uncertain =
              sunc > 0.5f || fabsf(dos) < kU64 * det_prods;
          float rel;
          if (isfinite(s)) {
            rel = (fabsf(s - c) - serr) * tab.s[t - l + 1];
          } else {
            rel = sign_uncertain ? -INFINITY : INFINITY;
          }
          round_margin = fminf(round_margin, rel);
        }
      }
      if (margin) mrg = fminf(mrg, round_margin);
      active = hit_last;
      if (!active) break;
      int pos = t_first;  // hit_last guarantees a hit
      if (pos < l + 1) pos = l + 1;
      packed[(pos / 31) * npix + pix] |= 1 << (pos % 31);
      l = pos;
      active = l < k - 1;
    }
    if (margin) {
      if (active && rounds < k - 1) mrg = -INFINITY;
      margin[pix] = mrg;
    }
  }
}

}  // namespace

extern "C" {

int nd_omnibus_max_k() { return kMaxK; }

int nd_omnibus_f32(const void* values, void* packed, void* margin,
                   long long npix, int k, const float* c_tab,
                   const float* s_tab, float nf, int rounds, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  Tables tab;
  for (int j = 0; j <= kMaxK; ++j) {
    tab.c[j] = j <= k ? c_tab[j] : -INFINITY;
    tab.s[j] = j <= k ? s_tab[j] : 0.f;
  }
  const int threads = 128;
  long long blocks = (npix + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  omnibus_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(values), static_cast<int*>(packed),
      static_cast<float*>(margin), npix, k, tab, nf, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
