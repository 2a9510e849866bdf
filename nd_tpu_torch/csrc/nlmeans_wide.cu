// Non-local means with wide search windows over a (n0, n1, n2, nv) cube,
// joint over the nv variables: the windows whose halo tile of every
// variable fits no block of nlmeans.cu.
//
// Replaces: the XLA program of nd_tpu/ops/nlmeans.py nlmeans (:46), whose
// offset scan body (:108) the reference runs for windows past its Pallas
// kernel's VMEM model (4 float32 variables at r = (10, 10, 3), f = 3; the
// textbook 21 x 21 search window with 7 x 7 patches, over +-3 dates).
//
// Bound on the H100: arithmetic, and in practice the latency of one
// block of 512 threads a SM. Per output and offset the work is nv squared
// differences over the patch region, three separable patch sums and one
// exp; built with -fmad=false, f32 products and sums issue as separate
// instructions, so half the data sheet's 67 TFLOP/s is the ceiling of
// this bit-faithful arithmetic. Device memory sees the cube padded once
// (read once, written once) and read once per block through its halo.
// The ring (about 172 KB at the phase-16 tile) and 126 registers a thread
// leave one block a SM; fewer threads a block measured slower in
// proportion (PERF.md, the forced tiles of `python -m
// nd_tpu_torch.scan_sweep routes`), so the design spends registers on
// independent work between barriers and keeps barriers few.
//
// The design:
//  - the wrapper reflect-pads the cube once (pad_kernel, numpy 'reflect'
//    on every axis) to whole tiles plus r + f on each side, so every read
//    below is affine: no boundary mapping, 16-byte copies;
//  - one block per output tile of ty x tx x tt positions (the wrapper's
//    _wide_plan picks it); each offset D of the window is evaluated in
//    one direction only, at the block's own outputs o: the pair (o, o+D).
//    A block then reads only its tile +- f (its own box) and the partner
//    box, tile + D +- f;
//  - the offsets run with dy outermost. The partner boxes of one dy (all
//    dx, all dt) lie in ty + 2 fy padded rows of (tx + 2(rx + fx)) x
//    (tt + 2(rt + ft)) positions; those rows sit in a ring of ty + 2 fy +
//    1 rows in shared memory (each x position's t run at an odd stride,
//    so that neighbouring x fall in distinct banks), and while one dy's
//    offsets compute, the row the next dy adds is copied in with
//    cp.async. A block reads its halo from device memory (L2) once,
//    against the global-halo route's two re-reads of the D-extended
//    region per offset pair;
//  - the fused build (float32, nv = 4, patches of at most 7 taps: the
//    textbook window): a thread owns a run of 4 t outputs of one region
//    row, keeps its 4 + 2 ft own values in registers, and for a window of
//    4 consecutive dt reads each partner position once, forming the
//    squared differences (summed over v) and their t sums in registers.
//    The ty + 2 fy rows of one (x, t run) column sit on consecutive lanes
//    of one warp, so the y pass (runs of 4 along y) needs only that warp;
//    its planes alternate by window, and one block barrier a window of 4
//    offsets precedes the last step: each output takes the x pass, the
//    weight exp(-max(dsq/dsq_norm - 2 sigma^2, 0)/h^2) and the weighted
//    partner for the window's offsets in order. Ring rows are padded to
//    1 mod 8 positions, so the rows of a column fall in distinct banks;
//  - the other builds (float64, other nv, wider patches) evaluate one
//    offset at a time: (1) the squared differences over the region into
//    a plane, (2) the t and y passes through planes, (3) as above; own
//    values in registers for nv = 4, in shared memory otherwise;
//  - where not even one ring row fits (windows of about 40 or more
//    positions on two axes), the unfused build reads the partner from the
//    padded cube in device memory (RING false).
//
// Cost against the global-halo route: each block evaluates all
// (2r+1)^3 - 1 offsets instead of half as many pairs, but over the region
// tile + 2f (5.4 x the outputs at tile (8, 8, 8), f = 3) instead of tile +
// |D| + 2f (8.0 x), and with no backward pass. float64 and nv = 8 double
// the ring: the plan takes a smaller tile (for example (4, 16, 4) at
// r = (5, 5, 5), f = 2 in float64).
//
// Numerics: the patch distances are bit-identical to the plain version's
// (ops/nlmeans.py nlmeans_plain): the squared differences summed over
// v = 0..nv-1, each patch pass adding its 2f+1 terms left to right, the
// division by dsq_norm; the pair (o, o-D) gives the negated difference,
// whose square is the same. The per-output add order is the offsets'
// row-major order over (dy, dx, dt), from (-ry, -rx, -rt) to (ry, rx, rt)
// without (0, 0, 0); the plain version adds per unordered pair D > 0 the
// forward term (D) and then the backward one (-D). So the weighted sums
// round apart by a few float32 ulps (within rtol 1e-5, atol 1e-6; float64
// rtol 1e-12). The exp is the device's expf / exp.

#include <cuda_runtime.h>

#include <type_traits>

#include "stage.cuh"

namespace {

constexpr int kMaxE = 8;          // region positions per thread
constexpr int kMaxOut = 2;        // outputs per thread
constexpr int kMaxThreads = 512;
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr int kFastTaps = 7;      // patch widths the unrolled builds take
constexpr int kRun = 4;           // a fused thread's run of t (y) outputs
constexpr int kGroup = 4;         // dt offsets a window of the fused build

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }

// numpy 'reflect' (edge excluded) for the positions a valid output reads
// (|j| < 2n - 1 because r + f < n); positions that only outputs beyond
// the array read are clamped into it.
__host__ __device__ __forceinline__ int reflect_src(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * n - 2 - j;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

template <typename T>
struct Params {
  int ny, nx, nt, nv;                // the cube
  int NY, NX, NT;                    // the padded cube
  int ry, rx, rt, fy, fx, ft;
  int ty, tx, tt;                    // output tile of one block
  T dsq_norm, two_sigma2, inv_h2, n_eff;
  int use_neff;
};

template <typename T>
__device__ __forceinline__ T weight(T patch, const Params<T>& p) {
  T g = patch / p.dsq_norm - p.two_sigma2;
  g = g < T(0) ? T(0) : g;           // NaN stays NaN, as clamp_min
  return exp_t<T>(-g * p.inv_h2);
}

// Positions of one ring row: sx x positions at the odd stride st | 1,
// padded to 1 mod 8 so that the 16-byte positions of consecutive rows
// fall in distinct banks.
__host__ __device__ inline int ring_row(int sx, int st) {
  const int n = sx * (st | 1);
  return n + ((9 - n % 8) % 8);
}

// Elements of shared memory of a block (the wrapper's wide_smem): the
// ring of ty + 2fy + 1 padded rows of every variable (ring only; each x
// position's t run at the odd stride st | 1, so that consecutive x fall
// in distinct banks), the planes of the patch passes (unfused: the
// region's squared differences, after t, after y; fused: after t, its t
// at the odd stride tt | 1, and after y in two buffers by window parity,
// for each of a window's kGroup offsets), and for generic nv the own box
// and the accumulators.
__host__ __device__ inline long long wide_elems(int ty, int tx, int tt,
                                                int ry, int rx, int rt,
                                                int fy, int fx, int ft,
                                                int nv, bool ring,
                                                bool fused) {
  const long long ey = ty + 2 * fy, ex = tx + 2 * fx, et = tt + 2 * ft;
  const long long rows =
      ring ? (ey + 1) * ring_row(tx + 2 * (rx + fx), tt + 2 * (rt + ft)) * nv
           : 0;
  const long long planes =
      fused ? kGroup * (ey * ex * (tt | 1) + 2LL * ty * ex * tt)
            : ey * ex * et + ey * ex * tt + (long long)ty * ex * tt;
  const long long generic =
      nv == 4 ? 0 : (ey * ex * et + (long long)ty * tx * tt) * nv;
  return rows + planes + generic;
}

// pad[(Y, X, T, v)] = in at the reflect-mapped position (Y - Py, X - Px,
// T - Pt); one block per padded (Y, X) row, threads over (T, v).
template <typename T>
__global__ void pad_kernel(const T* __restrict__ in, T* __restrict__ pad,
                           Params<T> p) {
  const int Py = p.ry + p.fy, Px = p.rx + p.fx, Pt = p.rt + p.ft;
  const int row_n = p.NT * p.nv;
  for (long long row = blockIdx.x; row < (long long)p.NY * p.NX;
       row += gridDim.x) {
    const int Y = (int)(row / p.NX);
    const int X = (int)(row - (long long)Y * p.NX);
    const long long src_row =
        ((long long)reflect_src(Y - Py, p.ny) * p.nx +
         reflect_src(X - Px, p.nx)) * p.nt;
    T* dst = pad + row * row_n;
    for (int e = threadIdx.x; e < row_n; e += blockDim.x) {
      const int it = e / p.nv;
      const int v = e - it * p.nv;
      dst[e] = in[(src_row + reflect_src(it - Pt, p.nt)) * p.nv + v];
    }
  }
}

// NV values of one position into registers: 16-byte loads where the
// position's bytes allow.
template <typename T, int NV>
__device__ __forceinline__ void load_pos(const T* __restrict__ src,
                                         T (&v)[NV]) {
  if constexpr (sizeof(T) == 4 && NV % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 8 && NV % 2 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 2; ++q) {
      const double2 d = reinterpret_cast<const double2*>(src)[q];
      v[2 * q] = d.x; v[2 * q + 1] = d.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NV; ++q) v[q] = src[q];
  }
}

// Local padded row L of the block (padded row y0 + L) into ring slot
// L % rs: sx positions of st * nv contiguous elements each, at a stride
// of sts positions.
template <typename T>
__device__ void load_ring_row(T* ring, const T* __restrict__ pad, int L,
                              int rs, int y0, int x0, int t0, int sx, int st,
                              int sts, int nv, const Params<T>& p) {
  const int seg = st * nv;                     // elements per x position
  const int dseg = sts * nv;
  T* dst = ring + (long long)(L % rs) * ring_row(sx, st) * nv;
  const T* src = pad + (((long long)(y0 + L) * p.NX + x0) * p.NT + t0) * nv;
  const long long xs = (long long)p.NT * nv;   // elements between x
  if ((nv * (int)sizeof(T)) % 16 == 0) {
    constexpr int per = 16 / (int)sizeof(T);
    const int chunks = seg / per;
    for (int c = threadIdx.x; c < sx * chunks; c += blockDim.x) {
      const int lx = c / chunks;
      const int w = (c - lx * chunks) * per;
      cp_async16(dst + lx * dseg + w, src + lx * xs + w);
    }
  } else {
    for (int c = threadIdx.x; c < sx * seg; c += blockDim.x) {
      const int lx = c / seg;
      const int w = c - lx * seg;
      cp_async_elem(dst + lx * dseg + w, src + lx * xs + w);
    }
  }
}

// A patch pass's sum of taps = 2f + 1 terms s[0], s[stride], ... added
// left to right. PF > 0: taps <= PF, the loads unrolled and issued
// together; PF == 0: any taps.
template <int PF, typename T>
__device__ __forceinline__ T patch_sum(const T* s, int stride, int taps) {
  if constexpr (PF > 0) {
    T v[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) v[u] = u < taps ? s[u * stride] : T(0);
    T sum = v[0];
#pragma unroll
    for (int u = 1; u < PF; ++u)
      if (u < taps) sum = sum + v[u];
    return sum;
  } else {
    T sum = s[0];
    for (int u = 1; u < taps; ++u) sum = sum + s[u * stride];
    return sum;
  }
}

// NV > 0: nv == NV, the own box and the accumulators in registers;
// NV == 0: any nv, both in shared memory. RING: the partner rows in the
// shared-memory ring, else read from the padded cube. PF: patch passes of
// at most PF taps (0: any). FUSED (float, nv = 4, the ring, PF = kFastTaps):
// the squared differences and the t pass in registers, TC outputs of a
// region column a thread, and the y pass in runs of TC outputs.
template <typename T, int NV, bool RING, int PF, bool FUSED>
__global__ void __launch_bounds__(kMaxThreads)
    nlmeans_wide(const T* __restrict__ pad, T* __restrict__ out,
                 Params<T> p) {
  using Off = typename std::conditional<RING, int, long long>::type;
  constexpr int NVR = NV > 0 ? NV : 1;
  constexpr int KIN = kRun + kFastTaps - 1;      // a fused run's inputs
  constexpr int DTG = FUSED ? kGroup : 1;        // dt offsets a window
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nv = NV > 0 ? NV : p.nv;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Px = p.rx + p.fx, Pt = p.rt + p.ft;
  const int ey = p.ty + 2 * p.fy, ex = p.tx + 2 * p.fx, et = p.tt + 2 * p.ft;
  const int sx = p.tx + 2 * Px, st = p.tt + 2 * Pt, sts = st | 1;
  const int rs = ey + 1;                         // ring rows
  const int nr = ey * ex * et;                   // region positions
  const int nout = p.ty * p.tx * p.tt;
  const int ntp = ey * ex * p.tt;                // after the t pass
  const int nyp = p.ty * ex * p.tt;              // after the y pass
  // the fused build's t-pass planes run their t at the odd stride tts
  const int tts = FUSED ? (p.tt | 1) : p.tt;
  const int ntpp = ey * ex * tts, planep = ex * tts;

  T* const ring = reinterpret_cast<T*>(smem_raw);
  const int rrow = ring_row(sx, st);             // positions a ring row
  T* const bX = ring + (RING ? (long long)rs * rrow * nv : 0);
  T* const bY = bX + (FUSED ? 0 : nr);           // DTG planes after t
  T* const bZ = bY + DTG * ntpp;                 // DTG planes after y (x2
                                                 // by window parity, fused)
  T* const own_s = bZ + (FUSED ? 2 : 1) * DTG * nyp;  // NV == 0
  T* const acc_s = own_s + (NV == 0 ? nr * nv : 0);

  // the block's tile origin; t fastest, then x, then y
  const int nbt = (p.nt + p.tt - 1) / p.tt;
  const int nbx = (p.nx + p.tx - 1) / p.tx;
  int b = blockIdx.x;
  const int t0 = (b % nbt) * p.tt;
  b /= nbt;
  const int x0 = (b % nbx) * p.tx;
  const int y0 = (b / nbx) * p.ty;

  // the partner's base and strides: ring slots, or the padded cube
  const T* const base = RING ? ring : pad;
  const Off xs = RING ? (Off)sts : (Off)p.NT;    // positions between x
  auto row_off = [&](int L) -> Off {             // local padded row L
    if constexpr (RING)
      return (Off)(L % rs) * rrow;
    else
      return ((Off)(y0 + L) * p.NX + x0) * p.NT + t0;
  };
  auto pad_at = [&](int i, int j, int k) {       // region position's own
    return pad + (((long long)(y0 + p.ry + i) * p.NX + (x0 + p.rx + j)) *
                      p.NT + (t0 + p.rt + k)) * nv;
  };

  // unfused: the thread's region positions e = tid + m * nth (t fastest)
  // and their own values; the t pass's sources. Fused: one run, row i1
  // of unit (j1, c) and outputs k1 = 4c .. k1 + n1 - 1 of the t pass, its
  // n1 + 2 ft own values; a unit is one (x, t run) column of the region,
  // its ey rows on consecutive lanes of one warp (upw units a warp), so
  // that its y pass needs no block barrier.
  T own[FUSED ? KIN : kMaxE][NVR];
  int tsrc[FUSED ? 1 : kMaxE];
  const int nch = (p.tt + kRun - 1) / kRun;      // t runs a column
  const int upw = 32 / ey;                       // units a warp (ey <= 32)
  const int lane = tid & 31, uw = lane / (ey < 32 ? ey : 32);
  const int unit = (tid >> 5) * upw + uw;
  const int i1 = lane - uw * ey, j1 = unit % ex, k1 = (unit / ex) * kRun;
  const bool run1 = FUSED && uw < upw && unit < ex * nch;
  const int n1 = p.tt - k1 < kRun ? p.tt - k1 : kRun;
  if constexpr (FUSED) {
#pragma unroll
    for (int kk = 0; kk < KIN; ++kk)
      if (run1 && kk < n1 + 2 * p.ft) load_pos<T, NVR>(pad_at(i1, j1, k1 + kk),
                                                      own[kk]);
  } else {
    for (int e = tid; NV == 0 && e < nr * nv; e += nth) {
      const int q = e / nv, v = e - q * nv;
      own_s[e] = pad_at(q / (et * ex), (q / et) % ex, q % et)[v];
    }
#pragma unroll
    for (int m = 0; m < kMaxE; ++m) {
      const int e = tid + m * nth;
      if (NV > 0 && e < nr)
        load_pos<T, NVR>(pad_at(e / (et * ex), (e / et) % ex, e % et),
                         own[m]);
      tsrc[m] = e + (e / p.tt) * 2 * p.ft;
    }
  }

  // the thread's outputs (oy, ox, ot) packed 10 bits each, -1 for none;
  // the x pass's sources; the accumulators
  int opack[kMaxOut], zsrc[kMaxOut];
  T acc[kMaxOut][NVR], wsum[kMaxOut], wx[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = tid + k * nth;
    const int ot = o % p.tt, ox = (o / p.tt) % p.tx, oy = o / (p.tt * p.tx);
    opack[k] = o < nout ? (oy << 20) | (ox << 10) | ot : -1;
    // the x pass reads the y pass's plane, or with fy = 0 the t pass's
    zsrc[k] = (oy * ex + ox) * (p.fy > 0 ? p.tt : tts) + ot;
    wsum[k] = T(0);
    wx[k] = T(0);
#pragma unroll
    for (int v = 0; v < NVR; ++v) acc[k][v] = T(0);
    for (int v = 0; NV == 0 && o < nout && v < nv; ++v) acc_s[o * nv + v] = T(0);
  }

  // the ring's first ey rows
  if constexpr (RING) {
    for (int L = 0; L < ey; ++L)
      load_ring_row(ring, pad, L, rs, y0, x0, t0, sx, st, sts, nv, p);
    cp_async_commit();
    wait_pending(0);
  }
  __syncthreads();

  const int taps_t = 2 * p.ft + 1, taps_y = 2 * p.fy + 1,
            taps_x = 2 * p.fx + 1;
  const bool pass_t = p.ft > 0, pass_y = p.fy > 0;
  const T* const Tb = pass_t || FUSED ? bY : bX;  // after the t pass
  const T* const Zb = pass_y ? bZ : Tb;          // after the y pass
  // fused y pass: runs of kRun outputs along y
  const int ny_runs = (p.ty + kRun - 1) / kRun;
  const int plane = ex * p.tt;

  int win = 0;                                   // windows so far (parity)
  for (int a = 0; a <= 2 * p.ry; ++a) {
    const int dy = a - p.ry;
    // the row the next dy adds, into the slot of the row this dy dropped
    if (RING && a < 2 * p.ry) {
      load_ring_row(ring, pad, a + ey, rs, y0, x0, t0, sx, st, sts, nv, p);
      cp_async_commit();
    }
    // this dy's partner offsets of the thread's positions and outputs
    Off eoff[FUSED ? 1 : kMaxE], ooff[kMaxOut];
    if constexpr (FUSED) {
      eoff[0] = row_off(a + (run1 ? i1 : 0)) + (Off)(p.rx + j1) * xs +
                (p.rt + k1);
    } else {
#pragma unroll
      for (int m = 0; m < kMaxE; ++m) {
        const int e = tid + m * nth;
        const int k = e % et, j = (e / et) % ex, i = e / (et * ex);
        eoff[m] = row_off(a + (e < nr ? i : 0)) + (Off)(p.rx + j) * xs +
                  (p.rt + k);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int oy = opack[k] >> 20, ox = (opack[k] >> 10) & 1023,
                ot = opack[k] & 1023;
      ooff[k] = opack[k] < 0 ? 0
                             : row_off(a + p.fy + oy) + (Off)(Px + ox) * xs +
                                   (Pt + ot);
    }

    // this dy's offsets in row-major order without (0, 0, 0): for each
    // dx, windows of DTG consecutive dt (slot d is dt0 + d; a slot past
    // rt or at the zero offset is left out)
    for (int dx = -p.rx; dx <= p.rx; ++dx) {
    for (int dt0 = -p.rt; dt0 <= p.rt; dt0 += DTG, ++win) {
      const int nd = p.rt - dt0 + 1 < DTG ? p.rt - dt0 + 1 : DTG;
      const int skip = dy == 0 && dx == 0 ? -dt0 : -1;   // the zero's slot
      const Off dbase = (Off)dx * xs + dt0;
      if constexpr (FUSED) {
        // (1) + (2t): the run's partner positions kk + d (kk < n1 + 2 ft)
        // read once for the window's nd offsets; each offset's squared
        // difference at kk added into the t sums of the outputs o with
        // o <= kk <= o + 2 ft, left to right
        if (run1) {
          const T* bp = base + (eoff[0] + dbase) * NV;
          const int nin = n1 + 2 * p.ft;
          T ts[DTG][kRun];
#pragma unroll
          for (int pp = 0; pp < KIN + DTG - 1; ++pp) {
            if (pp >= nin + nd - 1) break;
            T bv[NVR];
            load_pos<T, NVR>(bp + pp * NV, bv);
#pragma unroll
            for (int d = 0; d < DTG; ++d) {
              const int kk = pp - d;
              if (kk < 0 || kk >= KIN) continue;
              if (d >= nd || d == skip || kk >= nin) continue;
              T dv = own[kk][0] - bv[0];
              T s = dv * dv;
#pragma unroll
              for (int v = 1; v < NVR; ++v) {
                dv = own[kk][v] - bv[v];
                s = s + dv * dv;
              }
#pragma unroll
              for (int o = 0; o < kRun; ++o) {
                if (kk < o || kk - o >= kFastTaps) continue;
                if (kk == o)
                  ts[d][o] = s;
                else if (kk - o < taps_t)
                  ts[d][o] = ts[d][o] + s;
              }
            }
          }
#pragma unroll
          for (int d = 0; d < DTG; ++d) {
            if (d >= nd || d == skip) continue;
            T* dst = bY + d * ntpp + (i1 * ex + j1) * tts + k1;
#pragma unroll
            for (int o = 0; o < kRun; ++o)
              if (o < n1) dst[o] = ts[d][o];
          }
        }
        // (2y) runs of kRun outputs along y of the warp's units, into the
        // window's parity buffer: the t sums they read come from this warp
        T* const bZp = bZ + (win & 1) * DTG * nyp;
        if (pass_y) {
          __syncwarp();
          const int items = upw * ny_runs * DTG * kRun;
          for (int it = lane; it < items; it += 32) {
            const int ko = it & (kRun - 1), d = (it / kRun) % DTG;
            const int rest = it / (kRun * DTG);
            const int y2 = (rest % ny_runs) * kRun, u = rest / ny_runs;
            const int un = (tid >> 5) * upw + u;
            const int jj = un % ex, kc = (un / ex) * kRun;
            if (un >= ex * nch || d >= nd || d == skip || kc + ko >= p.tt)
              continue;
            const int n2 = p.ty - y2 < kRun ? p.ty - y2 : kRun;
            const T* src = bY + d * ntpp + y2 * planep + jj * tts + kc + ko;
            T v[KIN];
#pragma unroll
            for (int q = 0; q < KIN; ++q)
              v[q] = q < n2 + 2 * p.fy ? src[q * planep] : T(0);
            T* zd = bZp + d * nyp + y2 * plane + jj * p.tt + kc + ko;
#pragma unroll
            for (int o = 0; o < kRun; ++o) {
              if (o < n2) {
                T sum = v[o];
#pragma unroll
                for (int q = 1; q < kFastTaps; ++q)
                  if (q < taps_y) sum = sum + v[o + q];
                zd[o * plane] = sum;
              }
            }
          }
        }
        __syncthreads();
      } else {
        if (skip == 0) continue;                 // the zero offset
        const Off doff = dbase;
        // (1) squared differences over the region, summed over v
#pragma unroll
        for (int m = 0; m < kMaxE; ++m) {
          const int e = tid + m * nth;
          if (e >= nr) continue;
          const T* bp = base + (eoff[m] + doff) * nv;
          T s;
          if constexpr (NV > 0) {
            T bv[NVR];
            load_pos<T, NVR>(bp, bv);
            T d = own[m][0] - bv[0];
            s = d * d;
#pragma unroll
            for (int v = 1; v < NVR; ++v) {
              d = own[m][v] - bv[v];
              s = s + d * d;
            }
          } else {
            T d = own_s[e * nv] - bp[0];
            s = d * d;
            for (int v = 1; v < nv; ++v) {
              d = own_s[e * nv + v] - bp[v];
              s = s + d * d;
            }
          }
          bX[e] = s;
        }
        __syncthreads();
        // (2) patch sums over t, then y
        if (pass_t) {
#pragma unroll
          for (int m = 0; m < kMaxE; ++m) {
            const int q = tid + m * nth;
            if (q < ntp) bY[q] = patch_sum<PF>(bX + tsrc[m], 1, taps_t);
          }
          __syncthreads();
        }
        if (pass_y) {
#pragma unroll
          for (int m = 0; m < kMaxE; ++m) {
            const int q = tid + m * nth;
            if (q < nyp) bZ[q] = patch_sum<PF>(Tb + q, plane, taps_y);
          }
          __syncthreads();
        }
      }

      // (3) per offset, in order: the x pass, the weight and the weighted
      // partner
#pragma unroll
      for (int d = 0; d < DTG; ++d) {
        if (d >= nd) break;
        if (d == skip) continue;
        const Off doff = dbase + d;
        const T* zp = (FUSED && pass_y ? bZ + (win & 1) * DTG * nyp : Zb) +
                      d * (pass_y ? nyp : ntpp);
#pragma unroll
        for (int k = 0; k < kMaxOut; ++k) {
          if (opack[k] < 0) continue;
          const T w = weight(
              patch_sum<PF>(zp + zsrc[k], pass_y ? p.tt : tts, taps_x), p);
          wsum[k] = wsum[k] + w;
          if (p.use_neff)
            wx[k] = wx[k] + w * w;
          else
            wx[k] = w > wx[k] ? w : wx[k];
          const T* val = base + (ooff[k] + doff) * nv;
          if constexpr (NV > 0) {
            T vv[NVR];
            load_pos<T, NVR>(val, vv);
#pragma unroll
            for (int v = 0; v < NVR; ++v) acc[k][v] = acc[k][v] + w * vv[v];
          } else {
            T* as = acc_s + (tid + k * nth) * nv;
            for (int v = 0; v < nv; ++v) as[v] = as[v] + w * val[v];
          }
        }
      }
      // the next window's first step rewrites the plane read in (3)
      if (FUSED ? !pass_y : (!pass_t && !pass_y)) __syncthreads();
    }
    }
    if constexpr (RING) wait_pending(0);
    __syncthreads();
  }

  // self-weight and normalisation
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (opack[k] < 0) continue;
    const int oy = opack[k] >> 20, ox = (opack[k] >> 10) & 1023,
              ot = opack[k] & 1023;
    const int gy = y0 + oy, gx = x0 + ox, gt = t0 + ot;
    if (gy >= p.ny || gx >= p.nx || gt >= p.nt) continue;
    T w_self;
    if (p.use_neff) {
      const T n = p.n_eff;
      const T disc = n * wsum[k] * wsum[k] - n * n * wx[k] + n * wx[k];
      w_self = (wsum[k] + sqrt(disc)) / (n - T(1));
    } else {
      w_self = wx[k] == T(0) ? T(1) : wx[k];
    }
    const T total = wsum[k] + w_self;
    const T* center =
        pad + (((long long)(gy + p.ry + p.fy) * p.NX + (gx + Px)) * p.NT +
               (gt + Pt)) * nv;
    T* o = out + (((long long)gy * p.nx + gx) * p.nt + gt) * nv;
    if constexpr (NV > 0) {
#pragma unroll
      for (int v = 0; v < NVR; ++v)
        o[v] = (acc[k][v] + w_self * center[v]) / total;
    } else {
      const T* as = acc_s + (tid + k * nth) * nv;
      for (int v = 0; v < nv; ++v)
        o[v] = (as[v] + w_self * center[v]) / total;
    }
  }
}

template <typename T, int NV, bool RING, int PF, bool FUSED>
int launch_main(const T* pad, T* out, const Params<T>& p, long long blocks,
                int threads, size_t smem, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(
      nlmeans_wide<T, NV, RING, PF, FUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  nlmeans_wide<T, NV, RING, PF, FUSED>
      <<<(unsigned)blocks, threads, smem, s>>>(pad, out, p);
  return (int)cudaGetLastError();
}

// float: the fused build where it applies; double has none.
template <typename T>
int launch_fused(const T* pad, T* out, const Params<T>& p, long long blocks,
                 int threads, size_t smem, cudaStream_t s) {
  if constexpr (sizeof(T) == 4)
    return launch_main<T, 4, true, kFastTaps, true>(pad, out, p, blocks,
                                                    threads, smem, s);
  else
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* in, void* pad, void* out, int ny, int nx, int nt,
           int nv, int ry, int rx, int rt, int fy, int fx, int ft, int ty,
           int tx, int tt, int threads, int ring, int fused, double sigma,
           double h, double n_eff, void* stream) {
  if ((long long)ny * nx * nt == 0 || nv == 0) return 0;
  // the packed output coordinates take 10 bits per axis
  if (ty < 1 || tx < 1 || tt < 1 || ty > 1023 || tx > 1023 || tt > 1023 ||
      threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long ey = ty + 2 * fy, ex = tx + 2 * fx, et = tt + 2 * ft;
  if ((long long)ty * tx * tt > (long long)kMaxOut * threads)
    return (int)cudaErrorInvalidValue;
  // patch passes of at most kFastTaps taps unroll; the fused build takes
  // float, nv = 4, the ring and one run of kRun t outputs a thread
  const int widest = 2 * (fy > fx ? (fy > ft ? fy : ft) : (fx > ft ? fx : ft))
                     + 1;
  const bool fast = widest <= kFastTaps;
  if (fused) {
    // a warp holds whole units of ey rows
    if (sizeof(T) != 4 || nv != 4 || !ring || !fast || ey > 32 ||
        (ex * ((tt + kRun - 1) / kRun) + 32 / ey - 1) / (32 / ey) * 32 >
            threads)
      return (int)cudaErrorInvalidValue;
  } else if (ey * ex * et > (long long)kMaxE * threads) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)wide_elems(ty, tx, tt, ry, rx, rt, fy, fx, ft,
                                         nv, ring != 0, fused != 0) *
                      sizeof(T);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int nby = (ny + ty - 1) / ty, nbx = (nx + tx - 1) / tx,
            nbt = (nt + tt - 1) / tt;
  const long long blocks = (long long)nby * nbx * nbt;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.ny = ny; p.nx = nx; p.nt = nt; p.nv = nv;
  p.NY = nby * ty + 2 * (ry + fy);
  p.NX = nbx * tx + 2 * (rx + fx);
  p.NT = nbt * tt + 2 * (rt + ft);
  p.ry = ry; p.rx = rx; p.rt = rt; p.fy = fy; p.fx = fx; p.ft = ft;
  p.ty = ty; p.tx = tx; p.tt = tt;
  p.dsq_norm = T((double)nv * (2 * fy + 1) * (2 * fx + 1) * (2 * ft + 1));
  p.two_sigma2 = T(2.0 * (sigma * sigma));
  p.inv_h2 = T(1.0 / (h * h));
  p.n_eff = T(n_eff);
  p.use_neff = n_eff >= 0.0;
  cudaStream_t s = (cudaStream_t)stream;
  const T* src = static_cast<const T*>(in);
  T* padded = static_cast<T*>(pad);
  T* dst = static_cast<T*>(out);
  const long long rows = (long long)p.NY * p.NX;
  pad_kernel<T><<<(unsigned)(rows < 65536 ? rows : 65536), 256, 0, s>>>(
      src, padded, p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const bool nv4 = nv == 4;
  if (fused) return launch_fused<T>(padded, dst, p, blocks, threads, smem, s);
  if (!ring)
    return nv4 ? launch_main<T, 4, false, 0, false>(padded, dst, p, blocks,
                                                    threads, smem, s)
               : launch_main<T, 0, false, 0, false>(padded, dst, p, blocks,
                                                    threads, smem, s);
  if (!fast)
    return nv4 ? launch_main<T, 4, true, 0, false>(padded, dst, p, blocks,
                                                   threads, smem, s)
               : launch_main<T, 0, true, 0, false>(padded, dst, p, blocks,
                                                   threads, smem, s);
  return nv4 ? launch_main<T, 4, true, kFastTaps, false>(padded, dst, p,
                                                         blocks, threads,
                                                         smem, s)
             : launch_main<T, 0, true, kFastTaps, false>(padded, dst, p,
                                                         blocks, threads,
                                                         smem, s);
}

}  // namespace

extern "C" {

// pad: (ceil(ny/ty) ty + 2(ry+fy), ceil(nx/tx) tx + 2(rx+fx),
// ceil(nt/tt) tt + 2(rt+ft), nv) elements of scratch, written here; ring:
// 1 for the partner rows in shared memory, 0 to read them from pad;
// fused: 1 for the fused build (float, nv = 4, the ring, patches of at
// most 7 taps, ty + 2 fy <= 32, a warp for each 32 / (ty + 2 fy) units).
int nd_nlmeans_wide_f32(const void* in, void* pad, void* out, int ny, int nx,
                        int nt, int nv, int ry, int rx, int rt, int fy,
                        int fx, int ft, int ty, int tx, int tt, int threads,
                        int ring, int fused, double sigma, double h,
                        double n_eff, void* stream) {
  return launch<float>(in, pad, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft,
                       ty, tx, tt, threads, ring, fused, sigma, h, n_eff,
                       stream);
}

int nd_nlmeans_wide_f64(const void* in, void* pad, void* out, int ny, int nx,
                        int nt, int nv, int ry, int rx, int rt, int fy,
                        int fx, int ft, int ty, int tx, int tt, int threads,
                        int ring, int fused, double sigma, double h,
                        double n_eff, void* stream) {
  return launch<double>(in, pad, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft,
                        ty, tx, tt, threads, ring, fused, sigma, h, n_eff,
                        stream);
}

}  // extern "C"
