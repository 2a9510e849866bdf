// Non-separable VALID correlation over up to three adjacent axes, with
// scipy.ndimage origin padding and boundary modes rebuilt by index mapping.
//
// Replaces: nd_tpu/ops/conv.py _conv_valid (:123), the XLA convolution
// (lax.conv_general_dilated) that the JAX package runs for a kernel that
// does not factor into 1-d tap vectors. No Pallas kernel is involved
// there; this is the port's own stencil.
//
// Entry points nd_stencil_{f32,f64}: the input is a contiguous
// (outer, n0, n1, n2, inner) array and the weights a (k0, k1, k2) array of
// the ALREADY-FLIPPED kernel in the input's type, on the device and (the
// same values) on the host; output (o, i0, i1, i2, ii) reads input
// (o, i0 - lo0 + j0, i1 - lo1 + j1, i2 - lo2 + j2, ii) for every tap
// (j0, j1, j2), lo = (k - 1) / 2, a position outside the array mapped by
// the boundary mode. A two-axis filter passes n2 = 1, k2 = 1; ops/conv.py
// sums three-axis stencils for kernels over four or more axes.
//
// Bound on the H100: device-memory bytes at the path's windows (one read
// and one write of each element: 8 bytes in f32 against 2 * taps - 1 f32
// operations, 49 for a 5 x 5 disk, 53 for a 3 x 3 x 3 stencil). With
// -fmad=false a product and an add are two instructions, so the
// instruction rate comes second: about half the byte bound for those
// windows. The design keeps the window's re-reads out of device memory
// and out of most shared-memory reads:
//
//  - a block owns an output tile of T0 = G * R rows along n0 by T1
//    positions along n1 by a chunk of the contiguous n2 * inner row. Its
//    raw input box, (T0 + k0 - 1) x (T1 + k1 - 1) segments of
//    chunk + (k2 - 1) * inner elements, is staged in shared memory as
//    pieces: a whole box row where the chunk is the row and k2 == 1 (the
//    row of segments is contiguous in device memory), else each segment.
//    The box sits at its source's alignment, so a piece's in-range part
//    moves in 16-byte cp.async blocks, neighbouring threads on
//    neighbouring blocks; only positions outside the array are mapped by
//    the boundary mode, element by element;
//  - blocks are persistent (the SM count times the blocks that fit) and
//    copy their next tile's box into a second buffer while they compute
//    the current one;
//  - each thread owns one (n1 position, row element) of the tile, fixed
//    for the launch (no division per output), and a run of R outputs
//    along n0. It walks the R + k0 - 1 box rows of its column once; each
//    row's k1 * k2 values are read from shared memory once and added to
//    every output of the run for which that row is tap row j0: R * k0 *
//    k1 * k2 terms from (R + k0 - 1) * k1 * k2 reads (6.25 a disk output
//    at R = 16, against 25 values and 25 weights for an output formed
//    alone). R is 16 or 8 (default_plan, from python -m
//    nd_tpu_torch.scan_sweep stencil);
//  - every window of at most 7 rows along n0 and 9 taps a box row
//    (k1 * k2), and at most 64 f32 (32 f64) taps, has a build with its
//    tap counts known at compile time (the unrolled builds, one for each
//    (k0, k1 * k2), in stencil_f{32,64}_r{8,16}.cu so that nvcc builds
//    them in parallel): the weights travel by value in the launch
//    parameters and each is an immediate operand of its product; the
//    tap row of each (box row, output) pair is a constant, so no
//    per-output test or weight load is left in the run;
//  - other windows take the generic build: runtime loops over the taps,
//    the weights in shared memory.
// A kernel whose two boxes fit no tile (a 2-D window of more than about
// 58 taps a side over rows of 8 or more f32 elements) takes the direct
// route: every output from device memory (through L1 and L2), weights
// from device memory.
//
// Numerics: per output one accumulator over the taps in row-major order
// (j0, then j1, then j2): acc = -0 + w[0] * x[0] (which is the product
// itself, bit for bit), then acc = acc + w[t] * x[t]; zero weights
// included (a NaN under a zero weight propagates, as in the XLA
// convolution). A thread's run adds row r's terms to each output in turn,
// so each output still takes its terms in row-major order. Built with
// -fmad=false, so no multiply-add is contracted: the result equals the
// plain PyTorch version (ops/stencil_cuda.py stencil_plain), which does
// the same products and adds in the same order, bit for bit, and the
// result of an output does not depend on the tile, run or build it falls
// in (njobs chunks equal the whole call).

#include <cuda_runtime.h>

#include <cstring>
#include <mutex>

#include "stencil.cuh"

namespace {

using namespace nd_stencil;

// The direct route: one output per thread and step of a grid-stride loop,
// every tap read from device memory, weights too; the taps' order and the
// boundary mapping as in stencil_tiled.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_direct(const T* __restrict__ in, T* __restrict__ out,
                   const T* __restrict__ w, Geo g, long long total, int mode,
                   T cval) {
  const long long plane_len = (long long)g.n0 * g.n1 * g.row_len;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(e % g.row_len);
    long long rest = e / g.row_len;
    const int i1 = (int)(rest % g.n1);
    rest /= g.n1;
    const int i0 = (int)(rest % g.n0);
    const long long o = rest / g.n0;
    const T* plane = in + o * plane_len;
    T acc = T(-0.0);
    int t = 0;
    for (int j0 = 0; j0 < g.k0; ++j0) {
      const int r = edge_src(i0 - g.lo0 + j0, g.n0, mode);
      for (int j1 = 0; j1 < g.k1; ++j1) {
        const int c = edge_src(i1 - g.lo1 + j1, g.n1, mode);
        for (int j2 = 0; j2 < g.k2; ++j2, ++t) {
          int p = col + (j2 - g.lo2) * g.inner;
          if (p < 0 || p >= g.row_len) {
            int i2 = p >= 0 ? p / g.inner : -((-p + g.inner - 1) / g.inner);
            const int ii = p - i2 * g.inner;
            i2 = edge_src(i2, g.n2, mode);
            p = i2 < 0 ? -1 : i2 * g.inner + ii;
          }
          const T v = (r < 0 || c < 0 || p < 0)
                          ? cval
                          : plane[((long long)r * g.n1 + c) * g.row_len + p];
          acc = acc + v * w[t];
        }
      }
    }
    out[e] = acc;
  }
}

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// The least value >= v congruent to like mod m.
long long congruent(long long v, long long like, long long m) {
  return v + (((like - v) % m) + m) % m;
}

// Shared-memory wavefronts of a warp's box read over those of a read
// without bank conflicts: the first warp's lanes (x, l) read word
// x * seg + l (two words a lane in f64) of a group's rows.
double conflicts(const Geo& c, int item) {
  int words[32][64];
  int count[32] = {0};
  int most = 0;
  const int per = item / 4;
  for (int lane = 0; lane < 32 && lane < c.g0 * c.pos; ++lane) {
    const int grp = lane / c.pos, at = lane - grp * c.pos;
    const int x = at / c.chunk, l = at - x * c.chunk;
    const long long base =
        ((long long)grp * c.run * c.rstride + (long long)x * c.seg + l) * per;
    for (int h = 0; h < per; ++h) {
      const int word = (int)((base + h) % 4096);
      const int bank = word % 32;
      bool seen = false;
      for (int i = 0; i < count[bank]; ++i) seen |= words[bank][i] == word;
      if (!seen && count[bank] < 64) words[bank][count[bank]++] = word;
      if (count[bank] > most) most = count[bank];
    }
  }
  return most / (double)per;
}

// The tile: over the row chunks (the whole row; the row split evenly, or
// in powers of two, into chunks of at least 8 elements) and the thread
// groups along n0, the widest n1 extent that keeps g0 * t1 * chunk <=
// kThreads (balanced over n1), whose two boxes and the weights fit the
// shared memory; of these, the one with the least estimated instruction
// count a launch: the tap products and adds, the box reads (a bank conflict
// counted as four reads more), the staging items (40 instructions each,
// kBlocks 16-byte blocks or one element) and a tile's fixed work,
// ragged tiles and idle warps included. tiles == 0: no tile fits, the
// direct route.
Geo plan(int outer, int n0, int n1, int n2, int inner, int k0, int k1, int k2,
         int item, int run) {
  Geo g{};
  g.outer = outer;
  g.n0 = n0; g.n1 = n1; g.n2 = n2; g.inner = inner;
  g.row_len = n2 * inner;
  g.k0 = k0; g.k1 = k1; g.k2 = k2;
  g.lo0 = (k0 - 1) / 2; g.lo1 = (k1 - 1) / 2; g.lo2 = (k2 - 1) / 2;
  g.taps = k0 * k1 * k2;
  g.run = run;
  const int vec16 = 16 / item;
  const int k12 = k1 * k2;
  g.wpad = (int)round_up(g.taps, vec16);   // the generic build's weights
  const int least = g.row_len < 8 ? g.row_len : 8;
  int chunks[48];
  int nc = 0;
  if (g.row_len <= kThreads) chunks[nc++] = g.row_len;
  for (int m = 2; m <= 32; ++m) {
    const int c = (g.row_len + m - 1) / m;
    if (c <= kThreads && c < g.row_len && c >= least) chunks[nc++] = c;
  }
  for (int c = kThreads; c >= least; c /= 2)
    if (c < g.row_len) chunks[nc++] = c;
  double best = -1.0;
  Geo pick = g;
  for (int ci = 0; ci < nc; ++ci) {
    const int chunk = chunks[ci];
    for (int g0 = 1; g0 * chunk <= kThreads; g0 *= 2) {
      int t1 = kThreads / (g0 * chunk);
      if (t1 > n1) t1 = n1;
      const int nb1 = (n1 + t1 - 1) / t1;
      t1 = (n1 + nb1 - 1) / nb1;
      Geo c = g;
      c.g0 = g0;
      c.chunk = chunk;
      c.t1 = t1;
      c.t0 = g0 * run;
      c.pos = t1 * chunk;
      c.h0 = c.t0 + k0 - 1;
      c.h1 = t1 + k1 - 1;
      c.lp = chunk + (k2 - 1) * inner;
      c.flat = k2 == 1 && chunk == g.row_len &&
               (long long)n1 * g.row_len < (1LL << 30);
      const long long line = (long long)n1 * g.row_len;   // a row of n0
      c.vec = vec16;
      c.seg = c.flat ? g.row_len : (int)congruent(c.lp, g.row_len, vec16);
      const long long rstride = congruent(
          (long long)c.h1 * c.seg + vec16 - 1, line, vec16);
      const long long box = round_up((long long)c.h0 * rstride, vec16);
      if ((c.wpad + 2 * box) * item > kSmemMax) continue;
      c.rstride = (int)rstride;
      c.box = (int)box;
      c.nb0 = (n0 + c.t0 - 1) / c.t0;
      c.nb1 = nb1;
      c.nbc = (g.row_len + chunk - 1) / chunk;
      c.tiles = (long long)outer * c.nb0 * c.nb1 * c.nbc;
      // an interior tile's pieces: in-range length and positions outside
      const long long len = c.flat ? (long long)c.h1 * g.row_len : c.lp;
      const long long inr = c.flat ? len : (c.lp < g.row_len ? c.lp
                                                             : g.row_len);
      const long long nv = (inr + 2 * c.vec - 2) / c.vec;
      const long long items =
          (long long)c.h0 * (c.flat ? 1 : c.h1) *
          ((nv + kBlocks - 1) / kBlocks + (len - inr));
      const double threads = (double)((g0 * c.pos + 31) / 32 * 32);
      const double reads = (double)(run + k0 - 1) * k12 *
                           (1.0 + 4.0 * (conflicts(c, item) - 1.0));
      const double cost =
          (double)c.tiles *
          (threads * (2.0 * run * g.taps + reads + 60.0) + 40.0 * items);
      if (best < 0 || cost < best) {
        best = cost;
        pick = c;
      }
    }
  }
  if (best < 0) pick.tiles = 0;
  return pick;
}

// plan() of the last launches' extents (a plan costs tens of
// microseconds): a small table under a lock, filled round-robin.
Geo cached_plan(int outer, int n0, int n1, int n2, int inner, int k0, int k1,
                int k2, int item, int run) {
  struct Entry {
    int key[10];
    Geo g;
  };
  static std::mutex lock;
  static Entry table[32];
  static int used = 0, next = 0;
  const int key[10] = {outer, n0, n1, n2, inner, k0, k1, k2, item, run};
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < used; ++i)
      if (!std::memcmp(table[i].key, key, sizeof(key))) return table[i].g;
  }
  const Geo g = plan(outer, n0, n1, n2, inner, k0, k1, k2, item, run);
  std::lock_guard<std::mutex> hold(lock);
  std::memcpy(table[next].key, key, sizeof(key));
  table[next].g = g;
  next = (next + 1) % 32;
  if (used < 32) ++used;
  return g;
}

template <typename T, int R>
int launch_run(const T* in, T* out, const T* w, const Taps<T>& taps,
               const Geo& g, int mode, T cval, bool unroll,
               cudaStream_t s) {
  if (unroll && unrolled<T>(g.k0, g.k1, g.k2))
    return launch_grid<T, R>(g.k0, g.k1 * g.k2, in, out, w, taps, g, mode,
                             cval, s);
  return launch_tiled<T, 0, 1, R>(in, out, w, taps, g, mode, cval, s);
}

bool valid_run(int run) { return run == 8 || run == 16; }

// The run a launch takes when the caller leaves it to the kernel (run 0),
// from python -m nd_tpu_torch.scan_sweep stencil: 16 outputs a thread for
// an unrolled window whose box rows are whole contiguous rows (flat) or
// whose window spans the row (k2 > 1), 8 otherwise (rows cut in chunks
// for a two-axis window, the generic build).
template <typename T>
Geo default_plan(int outer, int n0, int n1, int n2, int inner, int k0, int k1,
                 int k2, bool unroll) {
  const int item = (int)sizeof(T);
  Geo g = cached_plan(outer, n0, n1, n2, inner, k0, k1, k2, item, 16);
  if (g.tiles && unroll && unrolled<T>(k0, k1, k2) && (g.flat || k2 > 1))
    return g;
  return cached_plan(outer, n0, n1, n2, inner, k0, k1, k2, item, 8);
}

template <typename T>
int launch(const void* in, void* out, long long outer, int n0, int n1, int n2,
           long long inner, const void* w, const void* wh, int k0, int k1,
           int k2, int mode, double cval, int run, int unroll, void* stream) {
  if (k0 < 1 || k1 < 1 || k2 < 1 || mode < 0 || mode > kWrap ||
      (run && !valid_run(run)))
    return (int)cudaErrorInvalidValue;
  if ((long long)n2 * inner >= (1LL << 31) || outer >= (1LL << 31) ||
      (long long)k0 * k1 * k2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (outer == 0 || n0 == 0 || n1 == 0 || n2 * inner == 0) return 0;
  Geo g = run ? cached_plan((int)outer, n0, n1, n2, (int)inner, k0, k1, k2,
                            (int)sizeof(T), run)
              : default_plan<T>((int)outer, n0, n1, n2, (int)inner, k0, k1,
                                k2, unroll != 0);
  g.mis = (int)((reinterpret_cast<uintptr_t>(in) / sizeof(T)) & (g.vec - 1));
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const T* wt = static_cast<const T*>(w);
  const T cv = T(cval);
  cudaStream_t s = (cudaStream_t)stream;
  if (g.tiles == 0) {
    const long long total = outer * n0 * (long long)n1 * g.row_len;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    stencil_direct<T><<<(unsigned)blocks, kThreads, 0, s>>>(src, dst, wt, g,
                                                           total, mode, cv);
    return (int)cudaGetLastError();
  }
  Taps<T> taps;
  std::memset(&taps, 0, sizeof(taps));
  if (g.taps <= param_taps<T>()) std::memcpy(taps.w, wh, sizeof(T) * g.taps);
  const bool un = unroll != 0;
  if (g.run == 16)
    return launch_run<T, 16>(src, dst, wt, taps, g, mode, cv, un, s);
  return launch_run<T, 8>(src, dst, wt, taps, g, mode, cv, un, s);
}

}  // namespace

extern "C" {

// The route a launch of these extents takes: 0
// direct, 1 tiled with runtime tap loops (the generic build), 2 tiled with
// the window unrolled. run 0: the default run (default_plan), else 8 or
// 16.
int nd_stencil_tiled(int n0, int n1, int n2, long long inner, int k0, int k1,
                     int k2, int item, int run, int unroll) {
  if ((run && !valid_run(run)) || (item != 4 && item != 8)) return -1;
  const Geo g =
      run ? cached_plan(1, n0, n1, n2, (int)inner, k0, k1, k2, item, run)
      : item == 4
          ? default_plan<float>(1, n0, n1, n2, (int)inner, k0, k1, k2, unroll)
          : default_plan<double>(1, n0, n1, n2, (int)inner, k0, k1, k2,
                                 unroll);
  if (g.tiles == 0) return 0;
  const bool un = unroll && (item == 4 ? unrolled<float>(k0, k1, k2)
                                       : unrolled<double>(k0, k1, k2));
  return un ? 2 : 1;
}

// w: the flipped kernel on the device; wh: the same values on the host
// (read during the call; the launch passes up to 64 f32 or 32 f64 of them
// by value). run: outputs a thread runs along n0 (0: default_plan's; 8 or
// 16). unroll 0 forces the generic build.
int nd_stencil_f32(const void* in, void* out, long long outer, int n0, int n1,
                   int n2, long long inner, const void* w, const void* wh,
                   int k0, int k1, int k2, int mode, double cval, int run,
                   int unroll, void* stream) {
  return launch<float>(in, out, outer, n0, n1, n2, inner, w, wh, k0, k1, k2,
                       mode, cval, run, unroll, stream);
}

int nd_stencil_f64(const void* in, void* out, long long outer, int n0, int n1,
                   int n2, long long inner, const void* w, const void* wh,
                   int k0, int k1, int k2, int mode, double cval, int run,
                   int unroll, void* stream) {
  return launch<double>(in, out, outer, n0, n1, n2, inner, w, wh, k0, k1, k2,
                        mode, cval, run, unroll, stream);
}

}  // extern "C"
