// Separable VALID correlation over up to three adjacent axes, with
// scipy.ndimage origin padding and boundary modes rebuilt by index mapping.
//
// Replaces: nd_tpu/ops/conv_pallas.py padless_convolve (:576),
// rowfused_convolve (:308) and separable_convolve_pallas (:117, two- and
// three-axis cases). One tiled kernel, sepconv_tiled, behind two entry
// points:
//
//  - nd_sepconv_{f32,f64} (two axes): the input is viewed as a contiguous
//    (outer, n0, n1, inner) array and filtered over n0 (taps t0) then n1
//    (taps t1); the kernel runs with n2 = 1 and a single tap of weight 1
//    on its third axis, which adds nothing and rounds nothing. The
//    multilook's (y, x, t, 4) cube is (1, y, x, t*4); OmnibusTest's
//    stacked (4, y, x, t) cube is (4, y, x, t).
//  - nd_sepconv3_{f32,f64} (three axes, temporal taps): the input is
//    viewed as a contiguous (n0, n1, n2, inner) array and filtered as the
//    reference's fused kernel does: over n2 (taps t2, time) first, then
//    n0 (t0, y), then n1 (t1, x). A one-variable (y, x, time) stack is
//    (y, x, t, 1).
//
// Bound on the H100: device-memory bytes, one read and one write of each
// element (8 bytes in f32). The design keeps the window's re-reads and
// the boundary out of device memory:
//
//  - one block walks output tiles of T0 x T1 (n0, n1) positions by a
//    chunk of the contiguous n2*inner row (grid-stride, as many blocks as
//    the SMs hold), the tile shape chosen on the host per call so the
//    halo re-read stays small for 3- and 9-tap windows while three to
//    four blocks fit on an SM;
//  - the tile's raw input box, (T0 + k0 - 1) x (T1 + k1 - 1) rows of
//    chunk + (k2 - 1)*inner row elements, is staged in shared memory once;
//    where the box lies inside the array (interior tiles) it is copied
//    with cp.async, 16 bytes at a time where the row's alignment allows,
//    without any boundary mapping; only edge tiles map positions with
//    edge_src, element by element;
//  - double-buffered where that costs no occupancy: the next tile's box
//    is in flight (cp.async) while the current one is summed (on the H100
//    a third or fourth resident block hides the copies as well, and
//    single-buffered tiles measured faster where the second buffer
//    would have cost one);
//  - the n2, n0 and n1 passes then run inside shared memory: every
//    partial sum is formed once per tile instead of once per output.
// A window too wide to stage runs the n2 pass from device memory
// instead, as a per-element loop.
//
// Tap vectors of up to kInlineTaps weights travel by value in the launch
// parameters, where a warp reads each weight as one broadcast operand.
// Longer ones (GaussianFilter past sigma 7.8 at truncate 4: 65 taps and
// more) come as device buffers that each block copies into shared memory
// once; the tile plan counts them, and its tile sides shrink to an axis
// shorter than a side, so a single long axis (the n1 axis of the
// (1, outer, n, inner) view ops/conv.py gives a one-axis pass) always
// finds a tile. Two long axes in one launch may find none: ops/conv.py
// pairs axes only up to kInlineTaps taps each.
//
// Numerics: the add order is that of ops.conv._shift_add_valid: per
// output, the n2 pass, then the n0 pass over those sums, then the n1 pass
// (uniform taps are summed first and scaled once; weighted taps multiply
// each term). Outside the array the 'constant' mode reads cval at the
// innermost level and the outer passes run over those values: the
// reference's pad-every-axis-then-pass semantics for any cval. Built with
// -fmad=false, so no multiply-add is contracted and the result equals the
// plain PyTorch version's separate operations.

#include <cuda_runtime.h>

namespace {

constexpr int kInlineTaps = 64;        // taps per axis passed by value
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;       // shared memory a block may use
constexpr int kSmemPerSM = 233472;     // shared memory of an SM
constexpr int kSmemReserved = 1024;    // the runtime's share per block
constexpr int kBlocksCounted = 3;      // blocks per SM the plan rewards

enum Mode { kReflect = 0, kMirror = 1, kNearest = 2, kConstant = 3, kWrap = 4 };

template <typename T>
struct Taps {
  T w[kInlineTaps];      // the weights, when k <= kInlineTaps
  const T* wl;           // the weights on the device (k > kInlineTaps)
  T scale;
  int k;
  int lo;
  int uniform;
  int apply_scale;
  __device__ __forceinline__ T at(int i) const {
    return wl ? wl[i] : w[i];
  }
};

// In-range source index of position j on an axis of n samples under the
// scipy.ndimage boundary mode; -1 means the constant fill.
__device__ __forceinline__ int edge_src(int j, int n, int mode) {
  if (j >= 0 && j < n) return j;
  switch (mode) {
    case kReflect: {  // numpy 'symmetric': -1 -> 0, n -> n-1
      int p = 2 * n;
      j %= p;
      if (j < 0) j += p;
      return j < n ? j : p - 1 - j;
    }
    case kMirror: {  // numpy 'reflect': -1 -> 1, n -> n-2
      if (n == 1) return 0;
      int p = 2 * n - 2;
      j %= p;
      if (j < 0) j += p;
      return j < n ? j : p - j;
    }
    case kNearest:
      return j < 0 ? 0 : n - 1;
    case kWrap:
      j %= n;
      return j < 0 ? j + n : j;
    default:
      return -1;
  }
}

// One pass's sum over its taps, in the reference's order; K > 0 is the
// tap count known at compile time (the loop unrolls), K == 0 reads t.k,
// K < 0 reads t.k and the weights from ws (shared memory: long taps).
template <int K, typename T>
__device__ __forceinline__ T tap_sum(const T* s, int stride, const Taps<T>& t,
                                     const T* ws) {
  if constexpr (K < 0) {
    T acc = t.uniform ? s[0] : s[0] * ws[0];
    for (int i = 1; i < t.k; ++i) {
      const T v = s[i * stride];
      acc = acc + (t.uniform ? v : v * ws[i]);
    }
    return t.apply_scale ? acc * t.scale : acc;
  } else {
    const int k = K > 0 ? K : t.k;
    T acc = t.uniform ? s[0] : s[0] * t.w[0];
#pragma unroll
    for (int i = 1; i < (K > 0 ? K : kInlineTaps); ++i) {
      if (K == 0 && i >= k) break;
      const T v = s[i * stride];
      acc = acc + (t.uniform ? v : v * t.w[i]);
    }
    return t.apply_scale ? acc * t.scale : acc;
  }
}

// cp.async: global -> shared without registers; 4, 8 or 16 bytes.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` (0 or 1) of the latest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Geometry of one launch, chosen on the host (plan()).
struct Geo {
  int outer, n0, n1, n2, inner, row_len;
  int t0, t1, chunk;       // output tile: (n0, n1) positions by row elems
  int h0, h1;              // halo rows and columns: T + k - 1
  int vec;                 // elements per cp.async (16 bytes or one)
  int shift, lp;           // raw row: start offset in the staged row, length
  int staged, nbuf, needs_t;
  int wtaps;               // long taps' weights in shared memory (k0+k1+k2)
  int nb0, nb1, nbc;       // tiles per axis
  long long tiles;
};

template <typename T>
struct Args {
  Taps<T> a0, a1, a2;
  int mode;
  T cval;
};

// The tile's raw box into shared memory: cp.async for an interior tile,
// boundary-mapped loads for an edge tile.
template <typename T>
__device__ void stage(const T* __restrict__ in, T* buf, long long tile,
                      const Geo& g, const Args<T>& a) {
  const int bc = (int)(tile % g.nbc);
  long long rest = tile / g.nbc;
  const int b1 = (int)(rest % g.nb1);
  rest /= g.nb1;
  const int b0 = (int)(rest % g.nb0);
  const long long o = rest / g.nb0;
  const int r0 = b0 * g.t0 - a.a0.lo, c0 = b1 * g.t1 - a.a1.lo;
  const int s_al = bc * g.chunk - a.a2.lo * g.inner - g.shift;
  const T* plane = in + o * g.n0 * (long long)g.n1 * g.row_len;
  const bool interior = r0 >= 0 && r0 + g.h0 <= g.n0 && c0 >= 0 &&
                        c0 + g.h1 <= g.n1 && s_al >= 0 &&
                        s_al + g.lp <= g.row_len;
  // each thread takes fixed (column, row element) slots of a halo row
  // and walks the h0 rows: one decomposition per slot and tile
  const long long row_step = (long long)g.n1 * g.row_len;
  if (interior) {
    const int per_row = g.lp / g.vec;
    const T* src0 = plane + ((long long)r0 * g.n1 + c0) * g.row_len + s_al;
    for (int e = threadIdx.x; e < g.h1 * per_row; e += blockDim.x) {
      const int c = e / per_row;
      const int j = (e - c * per_row) * g.vec;
      const T* src = src0 + (long long)c * g.row_len + j;
      T* dst = buf + c * g.lp + j;
      for (int r = 0; r < g.h0; ++r)
        cp_async(dst + r * g.h1 * g.lp, src + r * row_step,
                 g.vec * (int)sizeof(T));
    }
    return;
  }
  for (int e = threadIdx.x; e < g.h1 * g.lp; e += blockDim.x) {
    const int cc = e / g.lp;
    const int c = edge_src(c0 + cc, g.n1, a.mode);
    int p = s_al + (e - cc * g.lp);
    if (p < 0 || p >= g.row_len) {     // a t position beyond the row
      int i2 = p >= 0 ? p / g.inner : -((-p + g.inner - 1) / g.inner);
      const int ii = p - i2 * g.inner;
      i2 = edge_src(i2, g.n2, a.mode);
      p = i2 < 0 ? -1 : i2 * g.inner + ii;
    }
    const bool fill = c < 0 || p < 0;
    const T* src = fill ? plane : plane + (long long)c * g.row_len + p;
    for (int rr = 0; rr < g.h0; ++rr) {
      const int r = edge_src(r0 + rr, g.n0, a.mode);
      buf[rr * g.h1 * g.lp + e] =
          (fill || r < 0) ? a.cval : src[r * row_step];
    }
  }
}

// The n2 pass from device memory, for windows too wide to stage; LONG:
// the n2 weights are ws (shared memory), else a.a2.w.
template <bool LONG, typename T>
__device__ void direct_t_pass(const T* __restrict__ in, T* st, long long tile,
                              const Geo& g, const Args<T>& a, const T* ws) {
  const int bc = (int)(tile % g.nbc);
  long long rest = tile / g.nbc;
  const int b1 = (int)(rest % g.nb1);
  rest /= g.nb1;
  const int b0 = (int)(rest % g.nb0);
  const long long o = rest / g.nb0;
  const T* plane = in + o * g.n0 * (long long)g.n1 * g.row_len;
  const int col0 = bc * g.chunk;
  for (int e = threadIdx.x; e < g.h0 * g.h1 * g.chunk; e += blockDim.x) {
    const int l = e % g.chunk;
    const int rc = e / g.chunk;
    const int r = edge_src(b0 * g.t0 - a.a0.lo + rc / g.h1, g.n0, a.mode);
    const int c = edge_src(b1 * g.t1 - a.a1.lo + rc % g.h1, g.n1, a.mode);
    const int col = col0 + l;
    T tsum = T(0);
    if (col < g.row_len) {
      const int i2 = col / g.inner;
      const int ii = col - i2 * g.inner;
      const bool fill = r < 0 || c < 0;
      const T* src =
          fill ? plane : plane + ((long long)r * g.n1 + c) * g.row_len + ii;
      for (int u = 0; u < a.a2.k; ++u) {
        const int q = edge_src(i2 - a.a2.lo + u, g.n2, a.mode);
        const T v = (fill || q < 0) ? a.cval : src[(long long)q * g.inner];
        const T term = a.a2.uniform ? v : v * (LONG ? ws[u] : a.a2.w[u]);
        tsum = (u == 0) ? term : tsum + term;
      }
      if (a.a2.apply_scale) tsum = tsum * a.a2.scale;
    }
    st[e] = tsum;
  }
}

// KA: taps of the n0 and n1 passes, KB: of the n2 pass, when known at
// compile time (0: read from the taps; -1 for both: long taps, every
// pass's weights in shared memory).
template <typename T, int KA, int KB>
__global__ void __launch_bounds__(kThreads)
    sepconv_tiled(const T* __restrict__ in, T* __restrict__ out, Geo g,
                  Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const raw0 = reinterpret_cast<T*>(smem);
  const int raw_n = g.staged ? g.h0 * g.h1 * g.lp : 0;
  T* const raw1 = raw0 + (g.nbuf == 2 ? raw_n : 0);
  T* const st = raw0 + g.nbuf * raw_n;     // (h0, h1, chunk): n2 pass
  T* const sy = st + (g.needs_t ? g.h0 * g.h1 * g.chunk : 0);
  const int chunk = g.chunk;
  const int tid = threadIdx.x, nth = blockDim.x;
  // long taps: the three weight vectors, copied once per block
  T* const w0 = sy + g.t0 * g.h1 * chunk;
  T* const w1 = w0 + a.a0.k;
  T* const w2 = w1 + a.a1.k;
  if constexpr (KA < 0) {
    for (int i = tid; i < g.wtaps; i += nth) {
      const int j1 = i - a.a0.k, j2 = j1 - a.a1.k;
      w0[i] = j1 < 0 ? a.a0.at(i) : (j2 < 0 ? a.a1.at(j1) : a.a2.at(j2));
    }
    __syncthreads();
  }

  long long tile = blockIdx.x;
  if (g.staged && g.nbuf == 2 && tile < g.tiles) stage(in, raw0, tile, g, a);
  if (g.staged) cp_async_commit();
  for (int it = 0; tile < g.tiles; tile += gridDim.x, ++it) {
    // the rows the n0 pass reads: (h0, h1, S) with row stride S
    const T* ysrc = st;
    int S = chunk;
    if (g.staged) {
      T* cur = raw0;
      if (g.nbuf == 2) {
        cur = (it & 1) ? raw1 : raw0;
        const long long next = tile + gridDim.x;
        if (next < g.tiles) stage(in, (it & 1) ? raw0 : raw1, next, g, a);
        cp_async_commit();
        cp_async_wait(1);
      } else {
        stage(in, cur, tile, g, a);
        cp_async_commit();
        cp_async_wait(0);
      }
      __syncthreads();
      if (g.needs_t) {
        for (int e = tid; e < g.h1 * chunk; e += nth) {
          const int c = e / chunk;
          const T* s = cur + c * g.lp + g.shift + (e - c * chunk);
          for (int r = 0; r < g.h0; ++r)
            st[r * g.h1 * chunk + e] =
                tap_sum<KB>(s + r * g.h1 * g.lp, g.inner, a.a2, w2);
        }
        __syncthreads();
      } else {
        ysrc = cur + g.shift;
        S = g.lp;
      }
    } else {
      direct_t_pass<(KA < 0)>(in, st, tile, g, a, w2);
      __syncthreads();
    }

    // n0 pass: (T0, h1, chunk)
    const int yrow = g.h1 * S;
    for (int e = tid; e < g.h1 * chunk; e += nth) {
      const int c = e / chunk;
      const T* s = ysrc + c * S + (e - c * chunk);
      for (int y = 0; y < g.t0; ++y)
        sy[y * g.h1 * chunk + e] = tap_sum<KA>(s + y * yrow, yrow, a.a0, w0);
    }
    __syncthreads();

    // n1 pass into the output
    const int bc = (int)(tile % g.nbc);
    long long rest = tile / g.nbc;
    const int o1 = (int)(rest % g.nb1) * g.t1;
    rest /= g.nb1;
    const int o0 = (int)(rest % g.nb0) * g.t0;
    const long long o = rest / g.nb0;
    const int col0 = bc * chunk;
    const int ny = g.n0 - o0 < g.t0 ? g.n0 - o0 : g.t0;
    const long long out_row = (long long)g.n1 * g.row_len;
    T* dst = out + ((o * g.n0 + o0) * g.n1 + o1) * (long long)g.row_len + col0;
    for (int e = tid; e < g.t1 * chunk; e += nth) {
      const int x = e / chunk;
      const int l = e - x * chunk;
      if (o1 + x >= g.n1 || col0 + l >= g.row_len) continue;
      const T* s = sy + x * chunk + l;
      T* d = dst + (long long)x * g.row_len + l;
      for (int y = 0; y < ny; ++y)
        d[y * out_row] = tap_sum<KA>(s + y * g.h1 * chunk, chunk, a.a1, w1);
    }
    __syncthreads();
  }
}

// wl: the weights as T on the device (read when k > kInlineTaps)
template <typename T>
Taps<T> make_taps(const double* w, const void* wl, int k, int uniform,
                  int apply_scale) {
  Taps<T> t;
  for (int i = 0; i < kInlineTaps; ++i) t.w[i] = T(i < k ? w[i] : 0.0);
  t.wl = static_cast<const T*>(wl);
  t.k = k;
  t.lo = (k - 1) / 2;
  t.uniform = uniform;
  t.apply_scale = apply_scale;
  t.scale = T(w[0]);
  return t;
}

size_t smem_bytes(const Geo& g, size_t item) {
  const size_t raw = g.staged ? (size_t)g.h0 * g.h1 * g.lp : 0;
  const size_t st = g.needs_t ? (size_t)g.h0 * g.h1 * g.chunk : 0;
  return (g.nbuf * raw + st + (size_t)g.t0 * g.h1 * g.chunk + g.wtaps) *
         item;
}

// The tile. Estimated cost: the shared-memory and copy work of a tile
// (staging, the three passes, a fixed cost per tile) times the tiles,
// over the blocks an SM holds at its shared memory, counted up to 3.
// Candidates: T0, T1 in {8, 16, 32}, row chunks of up to 64 elements
// that split the row evenly, one or two raw buffers (a tie takes two),
// with at least two blocks per SM and staged row segments of at least
// 48 bytes unless they are whole rows (shorter segments waste most of
// each 32-byte sector); these limits and constants were chosen from a
// sweep of forced tiles over the five sepconv rows of chip_smoke.py on
// the H100 (PERF.md, section 6). A side longer than its axis is cut to the
// axis. If no tile meets them, the cheapest tile that fits; the n2 pass
// from device memory only when no staged tile fits at all. wtaps: the
// long taps' weights a block keeps in shared memory (0 for short taps).
template <typename T>
Geo plan(int outer, int n0, int n1, int n2, int inner, int k0, int k1, int k2,
         int needs_t, bool aligned, int wtaps) {
  Geo best{};
  double best_cost = 0.0;
  const int row_len = n2 * inner;
  const int vec = (aligned && row_len % (16 / (int)sizeof(T)) == 0)
                      ? 16 / (int)sizeof(T) : 1;
  const int lo2 = (k2 - 1) / 2;
  const int sides[3] = {8, 16, 32};
  for (int strict = 1, staged = 1; staged >= 0 && best.tiles == 0;
       strict ? (strict = 0) : (--staged, strict = 1))
    for (int nbuf = 1; nbuf <= (staged ? 2 : 1); ++nbuf)
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)
          for (int nch = (row_len + 63) / 64, n = 0; n < 64; ++nch, ++n) {
            int chunk = (row_len + nch - 1) / nch;
            chunk = (chunk + vec - 1) / vec * vec;
            Geo g{};
            g.outer = outer; g.n0 = n0; g.n1 = n1; g.n2 = n2;
            g.inner = inner; g.row_len = row_len;
            g.t0 = sides[a] < n0 ? sides[a] : n0;
            g.t1 = sides[b] < n1 ? sides[b] : n1;
            g.chunk = chunk;
            g.wtaps = wtaps;
            g.h0 = g.t0 + k0 - 1; g.h1 = g.t1 + k1 - 1;
            g.vec = vec;
            // the staged row starts at chunk*bc - lo2*inner, aligned down
            g.shift = ((-lo2 * inner) % vec + vec) % vec;
            g.lp = (g.shift + chunk + (k2 - 1) * inner + vec - 1) / vec * vec;
            g.staged = staged; g.nbuf = nbuf;
            g.needs_t = needs_t || !staged;
            const size_t smem = smem_bytes(g, sizeof(T));
            if (smem > (size_t)kSmemMax) {
              if (chunk <= vec) break;
              continue;
            }
            int per_sm = (int)(kSmemPerSM / (smem + kSmemReserved));
            if (strict && (per_sm < 2 || (g.lp * (int)sizeof(T) < 48 &&
                                          g.lp < row_len))) {
              if (chunk <= vec) break;
              continue;
            }
            per_sm = per_sm < kBlocksCounted ? per_sm : kBlocksCounted;
            g.nb0 = (n0 + g.t0 - 1) / g.t0;
            g.nb1 = (n1 + g.t1 - 1) / g.t1;
            g.nbc = (row_len + chunk - 1) / chunk;
            g.tiles = (long long)outer * g.nb0 * g.nb1 * g.nbc;
            const double outs = (double)g.t0 * g.t1 * chunk;
            const double work =
                (staged ? 2.0 * g.h0 * g.h1 * g.lp : 0.0) +
                (g.needs_t ? (double)g.h0 * g.h1 * chunk * (k2 + 1) : 0.0) +
                (double)g.t0 * g.h1 * chunk * (k0 + 1) + outs * (k1 + 2) +
                8192.0;
            const double cost = work * g.tiles / (per_sm > 0 ? per_sm : 1);
            if (best.tiles == 0 || cost < best_cost * 0.999 ||
                (cost <= best_cost * 1.001 && g.nbuf > best.nbuf)) {
              best = g;
              best_cost = cost;
            }
            if (chunk <= vec) break;
          }
  return best;
}

template <typename T, int KA, int KB>
int launch_tiled(const T* in, T* out, const Geo& g, const Args<T>& a,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(g, sizeof(T));
  int err = (int)cudaFuncSetAttribute(
      sepconv_tiled<T, KA, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sepconv_tiled<T, KA, KB>, kThreads, smem)))
    return err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > g.tiles) blocks = g.tiles;
  sepconv_tiled<T, KA, KB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      in, out, g, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, long long outer, int n0, int n1, int n2,
           long long inner, const double* w0, int k0, int uniform0,
           int scale0, const double* w1, int k1, int uniform1, int scale1,
           const double* w2, int k2, int uniform2, int scale2,
           const void* wl0, const void* wl1, const void* wl2, int mode,
           double cval, void* stream) {
  // device weights take the long-tap route: required past kInlineTaps,
  // allowed for shorter vectors (the route's timing against the inline
  // weights, nd_tpu_torch/scan_sweep.py taps)
  const bool long_taps = wl0 || wl1 || wl2;
  if (k0 < 1 || k1 < 1 || k2 < 1 || (k0 > kInlineTaps && !wl0) ||
      (k1 > kInlineTaps && !wl1) || (k2 > kInlineTaps && !wl2))
    return (int)cudaErrorInvalidValue;
  if ((long long)n2 * inner >= (1LL << 31) || outer >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (outer == 0 || n0 == 0 || n1 == 0 || n2 * inner == 0) return 0;
  const int needs_t = !(k2 == 1 && !scale2);
  // 16-byte copies need a 16-byte aligned input
  const bool aligned = (reinterpret_cast<unsigned long long>(in) & 15) == 0;
  Geo g = plan<T>((int)outer, n0, n1, n2, (int)inner, k0, k1, k2, needs_t,
                  aligned, long_taps ? k0 + k1 + k2 : 0);
  if (g.tiles == 0) return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.a0 = make_taps<T>(w0, wl0, k0, uniform0, scale0);
  a.a1 = make_taps<T>(w1, wl1, k1, uniform1, scale1);
  a.a2 = make_taps<T>(w2, wl2, k2, uniform2, scale2);
  a.mode = mode;
  a.cval = T(cval);
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (long_taps) return launch_tiled<T, -1, -1>(src, dst, g, a, s);
  // the path's windows (3 taps: multilook and boxcar; 9: the Gaussian
  // at sigma 1), on n0 and n1 and none or as many on n2, unroll their
  // tap loops
  if (k0 == k1 && g.staged && (k2 == 1 || k2 == k0)) {
    if (k0 == 3)
      return k2 == 1 ? launch_tiled<T, 3, 1>(src, dst, g, a, s)
                     : launch_tiled<T, 3, 3>(src, dst, g, a, s);
    if (k0 == 9)
      return k2 == 1 ? launch_tiled<T, 9, 1>(src, dst, g, a, s)
                     : launch_tiled<T, 9, 9>(src, dst, g, a, s);
  }
  return launch_tiled<T, 0, 0>(src, dst, g, a, s);
}

const double kOne = 1.0;

}  // namespace

extern "C" {

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int nd_sepconv_inline_taps() { return kInlineTaps; }

// wl0, wl1 (wl2): each axis' weights as the kernel's type on the device,
// required where its tap count exceeds kInlineTaps (null: the weights
// travel by value); any of them given takes the long-tap route.
int nd_sepconv_f32(const void* in, void* out, long long outer, int n0, int n1,
                   long long inner, const double* w0, int k0, int uniform0,
                   int scale0, const double* w1, int k1, int uniform1,
                   int scale1, const void* wl0, const void* wl1, int mode,
                   double cval, void* stream) {
  return launch<float>(in, out, outer, n0, n1, 1, inner, w0, k0, uniform0,
                       scale0, w1, k1, uniform1, scale1, &kOne, 1, 1, 0, wl0,
                       wl1, nullptr, mode, cval, stream);
}

int nd_sepconv_f64(const void* in, void* out, long long outer, int n0, int n1,
                   long long inner, const double* w0, int k0, int uniform0,
                   int scale0, const double* w1, int k1, int uniform1,
                   int scale1, const void* wl0, const void* wl1, int mode,
                   double cval, void* stream) {
  return launch<double>(in, out, outer, n0, n1, 1, inner, w0, k0, uniform0,
                        scale0, w1, k1, uniform1, scale1, &kOne, 1, 1, 0, wl0,
                        wl1, nullptr, mode, cval, stream);
}

int nd_sepconv3_f32(const void* in, void* out, int n0, int n1, int n2,
                    long long inner, const double* w0, int k0, int uniform0,
                    int scale0, const double* w1, int k1, int uniform1,
                    int scale1, const double* w2, int k2, int uniform2,
                    int scale2, const void* wl0, const void* wl1,
                    const void* wl2, int mode, double cval, void* stream) {
  return launch<float>(in, out, 1, n0, n1, n2, inner, w0, k0, uniform0,
                       scale0, w1, k1, uniform1, scale1, w2, k2, uniform2,
                       scale2, wl0, wl1, wl2, mode, cval, stream);
}

int nd_sepconv3_f64(const void* in, void* out, int n0, int n1, int n2,
                    long long inner, const double* w0, int k0, int uniform0,
                    int scale0, const double* w1, int k1, int uniform1,
                    int scale1, const double* w2, int k2, int uniform2,
                    int scale2, const void* wl0, const void* wl1,
                    const void* wl2, int mode, double cval, void* stream) {
  return launch<double>(in, out, 1, n0, n1, n2, inner, w0, k0, uniform0,
                        scale0, w1, k1, uniform1, scale1, w2, k2, uniform2,
                        scale2, wl0, wl1, wl2, mode, cval, stream);
}

}  // extern "C"
