// Long-series complex-Wishart omnibus change-point scan with bit-packed
// flags and decision margins, one thread per pixel, no restart rounds.
//
// Replaces: nd_tpu/ops/change_scan_pallas.py change_detection_scan
// (_scan_kernel). Input is a contiguous (npix, k, 4) float32 series of
// [C11, C12.re, C12.im, C22] with 3 <= k <= 256; outputs are the flag
// planes (bit t%31 of int32 plane t//31, planes of npix) and each
// pixel's smallest decision margin net of the f32 error bound (threshold
// fit error included).
//
// The restart chain of the omnibus scan advances monotonically in time,
// so O(k) passes replace the round kernel's O(rounds * k) work: A builds
// the ungated tentative chain (running sums reset at each hit,
// polynomial thresholds in sqrt(j)), B evaluates an anchor's global test
// [t, k-1] from suffix sums (exact f64 thresholds cast to f32 at the
// compare), C commits A's flags while the global tests of the anchors
// reached so far all reject.
//
// Bound on the H100: device-memory bytes (16 k per pixel in) and f32
// arithmetic (per step two determinants, two logs, a degree <= 14 Horner
// in the TPU kernel) are close, and unfused (-fmad=false) the kernel runs
// near the card's instruction issue rate; the TPU kernel kept six
// (k, ty, tx) planes in VMEM. Design: a block of P threads owns P consecutive
// pixels, whose series are one contiguous P * 16 k byte range of the
// input. It stages them through shared memory in chunks of T steps x P
// pixels with 16-byte cp.async copies, a warp copying runs of consecutive
// steps (coalesced); a pixel's row of a chunk sits at an odd stride of
// 16-byte units, so a warp's float4 reads of one step across 32 pixels
// are free of bank conflicts. The chunks go through a ring of `nbuf`
// buffers, chunk c in buffer c % nbuf: pass A walks them forward, keeping
// its tentative hits as bits (the word being filled in a register; a
// local array of 8 words takes one store per 32 steps); then B and C
// run fused walking them backward, starting with the nbuf chunks A saw
// last, still resident (with nbuf = the chunk count the series is read
// from device memory once). C's gate commits a prefix of A's tentative hits, so B needs its
// global test only at anchor 0 and at the tentative hits, and walks the
// other steps for the suffix sums alone (the kernel's comment at pass B
// says how the margin is folded); B recomputes each step's log|det| and
// conditioning rather than A keeping them in shared memory, which would
// cost the residency that hides the chain's latency. A also keeps no
// k-long array: it snapshots its running minimum at its first kSnap
// tentative hits, which is all that B needs but for rare long chains of
// committed flags. A's interior thresholds depend on the window length
// j alone: the block evaluates them once per j into a shared table, and
// A looks up the next length's while the current step's test runs, off
// the chain of dependent steps. The host plan (ops/change_scan_cuda.py
// _scan_plan) picks P, T and nbuf, from a sweep of forced plans on the
// card.
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
#include "stage.cuh"

namespace {

constexpr int kMaxK = 256;
constexpr int kMaxCoefs = 16;
constexpr int kMaxSmall = 4;
constexpr int kWords = (kMaxK + 31) / 32;
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;   // shared memory a block may use (H100)
constexpr int kSnap = 8;           // snapshots of A's running minimum

struct ScanTables {
  float coef[kMaxCoefs];      // F2 polynomial in z, lowest order first
  float f2_small[kMaxSmall];  // exact F2 for j = 2..5
  float s_small[kMaxSmall];   // exact margin scale for j = 2..5
  float cg[kMaxK + 1];        // global-test threshold per window length
  float sg[kMaxK + 1];        // global-test margin scale per length
  float f2_err, f2_infl, za, zb, nf;
  int ncoef, nsmall;
};

// NaN-propagating min / max (jnp.minimum / jnp.maximum): one instruction
// each, the canonical NaN where either input is NaN, as the card's
// arithmetic (and so the plain version on it) produces.
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Elem {
  float x11, x12r, x12i, x22, logdet, neg, cond;
};

// A step's log|det| and its conditioning |csd| with the sign bit of the
// determinant (csd = -cond where det < 0), as the TPU kernel stores them.
__device__ __forceinline__ void elem_terms(const float4 v, float* logdet,
                                           float* csd) {
  const float det = v.x * v.w - v.y * v.y - v.z * v.z;
  const float prods = fabsf(v.x * v.w) + v.y * v.y + v.z * v.z;
  *logdet = mlog(fabsf(det));
  const float cond = nmin(prods / nmax(fabsf(det), 1e-37f), 1e18f);
  *csd = det < 0.f ? -cond : cond;
}

__device__ __forceinline__ Elem make_elem(const float4 v, float logdet,
                                          float csd) {
  Elem e;
  e.x11 = v.x;
  e.x12r = v.y;
  e.x12i = v.z;
  e.x22 = v.w;
  e.logdet = logdet;
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

// The interior threshold of window length j: F2(j) from the polynomial
// in z = sqrt(j) za + zb (or the exact immediate for j = 2..5), the margin
// scale and 1/j.
struct Thresh {
  float f2v, scale, invj;
};

__device__ __forceinline__ Thresh thresh(float j, const ScanTables& tab) {
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
  Thresh h;
  h.f2v = f2v;
  h.scale = scale;
  h.invj = 1.0f / j;
  return h;
}

// Relative margin of the window's decision s < c: (|s - c| - serr) * scale,
// or -inf / +inf for a non-finite statistic (-inf where the sign of a
// determinant is within rounding of zero). `averaged` divides the sum's
// determinant by j^2 (invj = 1/j).
__device__ __forceinline__ float window_rel(const Sums& a, float j,
                                            float invj, bool averaged,
                                            float nf, float c, float scale,
                                            bool* hit) {
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

// The tentative chain of pass A: the running sums since the last hit and
// the window length j with its interior threshold (f2v, scale, 1/j).
struct Chain {
  Sums run;
  float4 th;
  float j;
  int ji;
  __device__ __forceinline__ void start(const float4 th2) {
    th = th2;
    j = 2.0f;
    ji = 2;
  }
  // Step t >= 1: A's margin of the window ending at t and whether the
  // window hits; the chain restarts at t on a hit. The next length's
  // threshold is looked up before the test, off the chain.
  __device__ __forceinline__ float step(const Elem& e, const float4* thr,
                                        const float4 th2,
                                        const ScanTables& tab, bool* hit) {
    const Sums a = run.plus(e);
    const float4 next = thr[ji + 1];
    const float rel = window_rel(a, j, th.z, true, tab.nf, -th.x, th.y, hit) -
                      tab.f2_err;
    if (*hit) {
      run.set(e);
      j = 2.0f;
      ji = 2;
      th = th2;
    } else {
      run = a;
      j = j + 1.0f;
      ji += 1;
      th = next;
    }
    return rel;
  }
};

__device__ __forceinline__ Elem step_elem(const float4 v) {
  float logdet, csd;
  elem_terms(v, &logdet, &csd);
  return make_elem(v, logdet, csd);
}

__global__ void __launch_bounds__(kMaxThreads)
    omnibus_scan_kernel(const float4* __restrict__ values,
                        int* __restrict__ packed, float* __restrict__ margin,
                        long long npix, int k, int T, int nbuf,
                        ScanTables tab) {
  extern __shared__ float4 smem[];
  const int P = blockDim.x;
  const int tid = threadIdx.x;
  const int S = T | 1;                     // odd row stride, 16-byte units
  const int C = (k + T - 1) / T;           // chunks
  const int ring = P * S;                  // float4s per buffer
  float4* const thr = smem + nbuf * ring;  // [j]: f2v, scale, 1/j
  float* const snap = reinterpret_cast<float*>(thr + k + 2);  // [kSnap][P]
  int* const emax = reinterpret_cast<int*>(thr);   // thr[0] is unused
  const long long p0 = (long long)blockIdx.x * P;
  const int pv = (int)min((long long)P, npix - p0);
  const bool mine = tid < pv;

  // ---- pass A: the ungated tentative chain (forward) ----
  for (int i = 0; i < min(nbuf, C); ++i)
    load_chunk(smem + i * ring, values, p0, pv, k, T, S, i);
  for (int j = 2 + tid; j <= k + 1; j += P) {
    const Thresh h = thresh((float)j, tab);
    thr[j] = make_float4(h.f2v, h.scale, h.invj, 0.f);
  }
  const Thresh h2 = thresh(2.0f, tab);
  const float4 th2 = make_float4(h2.f2v, h2.scale, h2.invj, 0.f);
  unsigned tent[kWords];      // tentative hits; bit t of word t / 32
  for (int w = 0; w < kWords; ++w) tent[w] = 0u;
  unsigned tcur = 0u;         // the word being filled, in a register
  Chain ch;
  ch.start(th2);
  float pm = INFINITY;        // minimum of A's margins at steps 1 .. t
  int nt = 0;                 // tentative hits so far
  for (int c = 0; c < C; ++c) {
    wait_pending(min(C - 1 - c, nbuf - 1));
    __syncthreads();
    if (mine) {
      const float4* row = smem + (c % nbuf) * ring + tid * S;
      const int t0 = c * T;
      const int t1 = min(k, t0 + T);
      for (int t = t0; t < t1; ++t) {
        const Elem e = step_elem(row[t - t0]);
        if (t == 0) {
          ch.run.set(e);
          continue;
        }
        bool hit;
        pm = nmin(pm, ch.step(e, thr, th2, tab, &hit));
        if (hit) {
          tcur |= 1u << (t & 31);
          if (nt < kSnap) snap[nt * P + tid] = pm;
          ++nt;
        }
        if ((t & 31) == 31 || t == k - 1) {
          tent[t >> 5] = tcur;
          tcur = 0u;
        }
      }
    }
    __syncthreads();
    if (c + nbuf < C)
      load_chunk(smem + (c % nbuf) * ring, values, p0, pv, k, T, S, c + nbuf);
  }

  // ---- passes B and C: the global tests that decide (backward) ----
  // The gate commits A's tentative hits t_1 < t_2 < ... in order while
  // the global test of anchor 0 and of each committed hit rejects: the
  // flags are the tentative hits up to the first t_m whose global test
  // does not reject (all of them if none), and the margin is the minimum
  // of B's margin at anchor 0, A's margins over the alive steps 1 .. t_m
  // (k-1 if none) and B's margins at t_1 .. t_m. So B tests only anchor 0
  // and the tentative hits, walking backward: W is the minimum of B's
  // margins over the hits that stay committed, E the last alive step and
  // ei its hit's rank. A's minimum up to E is pm where E = k-1, A's
  // snapshot at its ei-th hit for the first kSnap hits, and otherwise a
  // third pass (forward, in the blocks that need it) recomputes it. A
  // minimum does not depend on the order it is taken in and NaN
  // propagates either way, so the margin is the plain version's bit for
  // bit. Chunks C - nbuf .. C - 1 are still in their buffers.
  Sums sfx;                   // suffix sums [t, k-1]
  float W = INFINITY, rel0 = INFINITY;
  bool g0 = false;
  int E = k - 1, ei = -1, rank = nt;
  unsigned tword = 0u;
  for (int c = C - 1; c >= 0; --c) {
    wait_pending(min(c, nbuf - 1));
    __syncthreads();
    if (mine) {
      const float4* row = smem + (c % nbuf) * ring + tid * S;
      const int t0 = c * T;
      for (int t = min(k, t0 + T) - 1; t >= t0; --t) {
        const Elem e = step_elem(row[t - t0]);
        if ((t & 31) == 31 || t == k - 1) tword = tent[t >> 5];
        if (t == k - 1) {
          sfx.set(e);
        } else {
          sfx = sfx.plus(e);
        }
        if (t == 0 || ((tword >> (t & 31)) & 1u)) {
          float rel = INFINITY;     // windows of length 1 never test
          bool hit = false;
          const int jg = k - t;
          if (t < k - 1 && isfinite(tab.cg[jg]))   // -inf: never rejects
            rel = window_rel(sfx, (float)jg, 0.f, false, tab.nf, tab.cg[jg],
                             tab.sg[jg], &hit);
          if (t == 0) {
            rel0 = rel;
            g0 = hit;
          } else {
            --rank;
            W = nmin(rel, hit ? W : INFINITY);
            if (!hit) {
              E = t;
              ei = rank;
            }
          }
        }
      }
    }
    __syncthreads();
    if (c - nbuf >= 0)
      load_chunk(smem + (c % nbuf) * ring, values, p0, pv, k, T, S, c - nbuf);
  }
  float X = pm;               // A's minimum over the alive steps
  if (mine && ei >= 0 && ei < kSnap) X = snap[ei * P + tid];
  const bool redo = mine && g0 && ei >= kSnap;
  if (__syncthreads_or(redo)) {
    // ---- pass A again, to E, where E is past the last snapshot ----
    if (tid == 0) *emax = 0;
    __syncthreads();
    if (redo) atomicMax(emax, E);
    __syncthreads();
    const int clast = *emax / T;
    ch.start(th2);
    pm = INFINITY;
    for (int c = 0; c <= clast; ++c) {     // chunks 0 .. nbuf-1 resident
      wait_pending(min(C - 1 - c, nbuf - 1));
      __syncthreads();
      if (redo) {
        const float4* row = smem + (c % nbuf) * ring + tid * S;
        const int t0 = c * T;
        const int t1 = min(E + 1, t0 + T);
        for (int t = t0; t < t1; ++t) {
          const Elem e = step_elem(row[t - t0]);
          if (t == 0) {
            ch.run.set(e);
            continue;
          }
          bool hit;
          pm = nmin(pm, ch.step(e, thr, th2, tab, &hit));
        }
      }
      __syncthreads();
      if (c + nbuf < C)
        load_chunk(smem + (c % nbuf) * ring, values, p0, pv, k, T, S,
                   c + nbuf);
    }
    wait_pending(0);
    if (redo) X = pm;
  }
  if (mine) {
    margin[p0 + tid] = g0 ? nmin(rel0, nmin(X, W)) : rel0;
    // the committed flags: tentative hits 1 .. E, none unless anchor 0's
    // test rejects; repacked from 32-bit words into 31-bit planes
    unsigned long long pending = 0ull;
    int have = 0, w = 0;
    for (int p = 0; p < (k + 30) / 31; ++p) {
      if (have < 31) {
        unsigned word = 0u;
        if (w < kWords && g0) {
          const int lo = 32 * w;
          word = tent[w];
          if (E < lo + 31)
            word = E < lo ? 0u : word & (0xffffffffu >> (31 - (E - lo)));
        }
        pending |= (unsigned long long)word << have;
        have += 32;
        ++w;
      }
      packed[p * npix + p0 + tid] = (int)(pending & 0x7fffffffull);
      pending >>= 31;
      have -= 31;
    }
  }
}

long long scan_smem(int k, int threads, int T, int nbuf) {
  return (long long)nbuf * threads * (T | 1) * 16 + (long long)(k + 2) * 16 +
         (long long)kSnap * threads * 4;
}

}  // namespace

extern "C" {

int nd_omnibus_scan_max_k() { return kMaxK; }

// Shared-memory bytes of a block of the plan (the Python plan's own
// formula, exposed so that a card test can hold the two together).
long long nd_omnibus_scan_smem(int k, int threads, int T, int nbuf) {
  return scan_smem(k, threads, T, nbuf);
}

// Lets the kernel use up to kSmemMax bytes of dynamic shared memory on
// the current device; the wrapper calls it once per device.
int nd_omnibus_scan_setup() {
  return (int)cudaFuncSetAttribute(omnibus_scan_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemMax);
}

int nd_omnibus_scan_f32(const void* values, void* packed, void* margin,
                        long long npix, int k, int threads, int T, int nbuf,
                        const double* coef, int ncoef, const double* f2_small,
                        const double* s_small, int nsmall, const double* cg,
                        const double* sg, double f2_err, double f2_infl,
                        double za, double zb, double nf, void* stream) {
  if (k < 3 || k > kMaxK || ncoef < 1 || ncoef > kMaxCoefs || nsmall < 0 ||
      nsmall > kMaxSmall || threads < 1 || threads > kMaxThreads || T < 1 ||
      T > k || nbuf < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = scan_smem(k, threads, T, nbuf);
  const long long blocks = (npix + threads - 1) / threads;
  if (smem > kSmemMax || blocks >= (1LL << 31))
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
  omnibus_scan_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                        (cudaStream_t)stream>>>(
      static_cast<const float4*>(values), static_cast<int*>(packed),
      static_cast<float*>(margin), npix, k, T, nbuf, tab);
  return (int)cudaGetLastError();
}

}  // extern "C"
