// Fast (float32) complex-Wishart omnibus change-point scan with restart
// rounds, bit-packed flags and decision margins, one thread per pixel.
//
// Replaces: nd_tpu/ops/change_pallas.py change_detection_pallas (_kernel,
// _mlog). Input is a contiguous (npix, k, 4) float32 series of
// [C11, C12.re, C12.im, C22] with k <= 256; outputs are the flag planes
// (bit t%31 of int32 plane t//31, planes of npix) and, with MARGIN, each
// pixel's smallest decision margin net of the f32 error bound.
//
// Bound on the H100: device-memory bytes (16 k in, 4 ceil(k/31) + 4 out
// per pixel) with f32 arithmetic close behind: a restart round walks
// [l, k-1], each step adding to the running sums and, from l+1 on,
// testing its window (a determinant, one log, the margin's bound). The
// TPU kernel unrolled the rounds over masked vector tiles. Here a block
// of P threads owns P consecutive pixels, whose series are one contiguous
// range of the input, and stages them through shared memory with
// coalesced 16-byte cp.async copies (csrc/stage.cuh) into rows of an odd
// stride, as the long-series scan (omnibus_scan.cu) does; the folded
// thresholds C(j) and margin scales S(j) sit in shared memory, where a
// warp's reads at its lanes' own window lengths do not serialise as they
// did in the parameter bank. Two modes, picked on the host
// (ops/change_cuda.py _round_plan) from a sweep of forced plans:
//
//  - resident (the whole series fits the ring: nbuf >= ceil(k/T)): the
//    series is staged once and every thread runs its own rounds from
//    shared memory without further barriers. The step terms that do not
//    depend on the anchor l (log|det|, the conditioning, and the
//    negative-determinant and uncertain-sign bits) are recomputed in
//    every round: kept in shared memory or in registers instead, they
//    lost at every k of the plan sweep (the terms' bytes cost the
//    residency that hides the loads);
//  - streamed (long series): the block walks its rounds in lockstep from
//    the smallest anchor of its active pixels, restaging the chunks of T
//    steps through a ring of nbuf buffers each round (the block's series
//    stay in L2 between rounds).
//
// Numerics: the same round scan as the TPU kernel and the plain version
// (ops/change_cuda.py omnibus_plain), every operation on the same
// operands: f32 running sums from the anchor l, the folded per-length
// immediates C(j) and S(j) computed on the host in float64, first hit by
// minimum, and the max_rounds cap with still-active pixels given margin
// -inf. The negative-determinant and uncertain-sign counts are exact small
// integers in the plain version, so their parity and their test > 0.5 are
// kept as bits. _mlog is ported as mlog() in mlog.cuh, so the calibrated
// 1e-5-per-log and 64*1.2e-7 conditioning terms of the margin bound keep
// their meaning. FMA policy: built with -fmad=false, so every product and
// sum rounds separately, as in the plain PyTorch version and in the TPU
// kernel the bound was calibrated on. fminf drops a NaN, which is safe
// here because a non-finite statistic becomes a +-inf margin before the
// minimum.

#include <cuda_runtime.h>
#include <cmath>

#include "mlog.cuh"
#include "stage.cuh"

namespace {

constexpr int kMaxK = 256;
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;   // shared memory a block may use (H100)
constexpr int kStatic = (2 * (kMaxK + 1) + 2) * 4;   // tables + anchors
constexpr float kU64 = (float)(64 * 1.2e-7);
constexpr float kLogErr = 1e-5f;

// The terms of one step that do not depend on the anchor.
struct Terms {
  float ld, cond;  // log|det|, conditioning (MARGIN)
  bool neg, unc;   // det < 0, |det| within rounding of 0 (MARGIN)
};

template <bool MARGIN>
__device__ __forceinline__ Terms terms_of(const float4 v) {
  Terms e;
  const float det = v.x * v.w - v.y * v.y - v.z * v.z;
  e.ld = mlog(fabsf(det));
  e.neg = det < 0.f;
  if (MARGIN) {
    const float prods = fabsf(v.x * v.w) + v.y * v.y + v.z * v.z;
    e.cond = fminf(prods / fmaxf(fabsf(det), 1e-37f), 1e18f);
    e.unc = fabsf(det) < kU64 * prods;
  } else {
    e.cond = 0.f;
    e.unc = false;
  }
  return e;
}

// One restart round's state: the running sums from the anchor l.
struct Round {
  float s11, s12r, s12i, s22, sld, scond;
  bool odd, unc;      // parity of negative determinants, any uncertain sign
  float margin;       // the round's smallest margin
  int t_first;        // first hit (-1: none)
  bool hit_last;      // the global test [l, k-1] hits
  __device__ __forceinline__ void start() {
    s11 = s12r = s12i = s22 = sld = scond = 0.f;
    odd = unc = false;
    margin = INFINITY;
    t_first = -1;
    hit_last = false;
  }
  // Step t >= l with the series value v and its terms e.
  template <bool MARGIN>
  __device__ __forceinline__ void step(const float4 v, const Terms& e, int t,
                                       int l, int k, float nf,
                                       const float* ctab, const float* stab) {
    s11 = s11 + v.x;
    s12r = s12r + v.y;
    s12i = s12i + v.z;
    s22 = s22 + v.w;
    sld = sld + e.ld;
    odd = odd != e.neg;
    if (MARGIN) {
      scond = scond + e.cond;
      unc = unc || e.unc;
    }
    if (t < l + 1) return;
    const float jt = (float)(t - l + 1);
    const float dos = s11 * s22 - s12r * s12r - s12i * s12i;
    const float log_prod = odd ? NAN : sld;
    const float s = nf * log_prod - (nf * jt) * mlog(dos);
    const float c = ctab[t - l + 1];
    const bool hit = s < c;
    if (hit && t_first < 0) t_first = t;
    if (t == k - 1) hit_last = hit;
    if (MARGIN && isfinite(c)) {
      const float det_prods = fabsf(s11 * s22) + s12r * s12r + s12i * s12i;
      const float cond_sum =
          fminf(det_prods / fmaxf(fabsf(dos), 1e-37f), 1e18f);
      const float serr =
          nf * ((scond + jt * cond_sum) * kU64 + (jt + 1.0f) * kLogErr);
      const bool sign_uncertain = unc || fabsf(dos) < kU64 * det_prods;
      float rel;
      if (isfinite(s)) {
        rel = (fabsf(s - c) - serr) * stab[t - l + 1];
      } else {
        rel = sign_uncertain ? -INFINITY : INFINITY;
      }
      margin = fminf(margin, rel);
    }
  }
};

// The end of a round: commit its first hit when the global test hits.
// Returns whether the pixel stays active.
template <bool MARGIN>
__device__ __forceinline__ bool finish(const Round& r, int* l, float* mrg,
                                       int* __restrict__ packed,
                                       long long npix, long long pix, int k) {
  if (MARGIN) *mrg = fminf(*mrg, r.margin);
  if (!r.hit_last) return false;
  int pos = r.t_first;  // hit_last guarantees a hit
  if (pos < *l + 1) pos = *l + 1;
  packed[(pos / 31) * npix + pix] |= 1 << (pos % 31);
  *l = pos;
  return pos < k - 1;
}

template <bool MARGIN>
__global__ void __launch_bounds__(kMaxThreads)
    omnibus_kernel(const float4* __restrict__ values,
                   int* __restrict__ packed, float* __restrict__ margin,
                   long long npix, int k, int T, int nbuf,
                   const float* __restrict__ c_tab,
                   const float* __restrict__ s_tab, float nf, int rounds) {
  extern __shared__ float4 smem[];
  __shared__ float ctab[kMaxK + 1], stab[kMaxK + 1];
  __shared__ int lmin[2];
  const int P = blockDim.x;
  const int tid = threadIdx.x;
  const int S = T | 1;                      // odd row stride, 16-byte units
  const int C = (k + T - 1) / T;            // chunks
  const int ring = P * S;                   // float4s per buffer
  const long long p0 = (long long)blockIdx.x * P;
  const int pv = (int)min((long long)P, npix - p0);
  const bool mine = tid < pv;
  const long long pix = p0 + tid;
  const bool resident = nbuf >= C;

  for (int j = tid; j <= k; j += P) {
    ctab[j] = c_tab[j];
    stab[j] = s_tab[j];
  }
  if (tid == 0) lmin[0] = k;
  if (mine)
    for (int pp = 0; pp < (k + 30) / 31; ++pp) packed[pp * npix + pix] = 0;
  float mrg = INFINITY;
  int l = 0;
  bool active = mine && k > 1;

  if (resident) {
    for (int c = 0; c < C; ++c)
      load_chunk(smem + c * ring, values, p0, pv, k, T, S, c);
    wait_pending(0);
    __syncthreads();
    // each thread's own rounds, from shared memory
    for (int round = 0; round < rounds && active; ++round) {
      Round r;
      r.start();
      for (int c = l / T; c < C; ++c) {
        const float4* row = smem + c * ring + tid * S;
        const int t0 = c * T, t1 = min(k, t0 + T);
        for (int t = max(l, t0); t < t1; ++t) {
          const float4 v = row[t - t0];
          r.step<MARGIN>(v, terms_of<MARGIN>(v), t, l, k, nf, ctab, stab);
        }
      }
      active = finish<MARGIN>(r, &l, &mrg, packed, npix, pix, k);
    }
  } else {
    // rounds in lockstep: each round restages the chunks from the block's
    // smallest active anchor on
    for (int round = 0; round < rounds; ++round) {
      __syncthreads();   // the last round's reads of the ring are done
      if (active) atomicMin(&lmin[round & 1], l);
      if (tid == 0) lmin[(round + 1) & 1] = k;
      __syncthreads();
      const int lo = lmin[round & 1];
      if (lo >= k) break;   // no pixel of the block is active
      const int cs = lo / T;
      for (int c = cs; c < min(C, cs + nbuf); ++c)
        load_chunk(smem + (c % nbuf) * ring, values, p0, pv, k, T, S, c);
      Round r;
      r.start();
      for (int c = cs; c < C; ++c) {
        wait_pending(min(C - 1 - c, nbuf - 1));
        __syncthreads();
        if (active) {
          const float4* row = smem + (c % nbuf) * ring + tid * S;
          const int t0 = c * T, t1 = min(k, t0 + T);
          for (int t = max(l, t0); t < t1; ++t) {
            const float4 v = row[t - t0];
            r.step<MARGIN>(v, terms_of<MARGIN>(v), t, l, k, nf, ctab, stab);
          }
        }
        __syncthreads();
        if (c + nbuf < C)
          load_chunk(smem + (c % nbuf) * ring, values, p0, pv, k, T, S,
                     c + nbuf);
      }
      if (active) active = finish<MARGIN>(r, &l, &mrg, packed, npix, pix, k);
    }
  }
  if (MARGIN && mine) {
    if (active && rounds < k - 1) mrg = -INFINITY;
    margin[pix] = mrg;
  }
}

long long round_smem(int threads, int T, int nbuf) {
  return (long long)nbuf * threads * (T | 1) * 16;
}

template <bool MARGIN>
int setup_one() {
  return (int)cudaFuncSetAttribute(omnibus_kernel<MARGIN>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemMax - kStatic);
}

}  // namespace

extern "C" {

int nd_omnibus_max_k() { return kMaxK; }

// Dynamic shared-memory bytes of a block of the plan (the Python plan's
// own formula, exposed so that a card test can hold the two together);
// the tables and anchors add kStatic bytes of static shared memory.
long long nd_omnibus_smem(int threads, int T, int nbuf) {
  return round_smem(threads, T, nbuf);
}

int nd_omnibus_static_smem() { return kStatic; }

// Lets the kernel's two variants use up to kSmemMax bytes of shared
// memory on the current device; the wrapper calls it once per device.
int nd_omnibus_setup() {
  const int err = setup_one<false>();
  return err ? err : setup_one<true>();
}

// c_tab, s_tab: k+1 float32 entries each, on the device. margin: null
// for flags alone.
int nd_omnibus_f32(const void* values, void* packed, void* margin,
                   long long npix, int k, int threads, int T, int nbuf,
                   const void* c_tab, const void* s_tab, float nf,
                   int rounds, void* stream) {
  if (k < 1 || k > kMaxK || threads < 1 || threads > kMaxThreads ||
      threads % 32 || T < 1 || T > k || nbuf < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = round_smem(threads, T, nbuf);
  const long long blocks = (npix + threads - 1) / threads;
  if (smem > kSmemMax - kStatic || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (npix == 0) return 0;
  const float4* v = static_cast<const float4*>(values);
  int* p = static_cast<int*>(packed);
  float* m = static_cast<float*>(margin);
  const float* ct = static_cast<const float*>(c_tab);
  const float* st = static_cast<const float*>(s_tab);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  const size_t sm = (size_t)smem;
  if (m)
    omnibus_kernel<true><<<g, threads, sm, s>>>(v, p, m, npix, k, T, nbuf,
                                                ct, st, nf, rounds);
  else
    omnibus_kernel<false><<<g, threads, sm, s>>>(v, p, m, npix, k, T, nbuf,
                                                 ct, st, nf, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
