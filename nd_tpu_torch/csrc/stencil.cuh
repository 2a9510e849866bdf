// The stencil kernel's templates (csrc/stencil.cu has the design): the
// staging, the thread's run, the tiled kernel and its launch. The
// unrolled builds, one for each (k0, k1 * k2) window up to (kRows,
// kRowTaps), are instantiated in stencil_f32_r8.cu, stencil_f32_r16.cu,
// stencil_f64_r8.cu and stencil_f64_r16.cu (launch_grid), one translation
// unit each, so that nvcc builds them in parallel; stencil.cu holds the
// plan, the generic build, the direct route and the entry points.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>
#include <utility>

#include "stage.cuh"

namespace nd_stencil {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;      // shared memory a block may use
constexpr int kParamBytes = 256;      // weights passed by value
constexpr int kBlocks = 4;            // vec-blocks a staging item copies
constexpr int kRows = 7;              // the unrolled builds: k0 <= kRows,
constexpr int kRowTaps = 9;           // k1 * k2 <= kRowTaps

enum Mode { kReflect = 0, kMirror = 1, kNearest = 2, kConstant = 3, kWrap = 4 };

// In-range source index of position j on an axis of n samples under the
// scipy.ndimage boundary mode; -1 means the constant fill (sepconv.cu's
// mapping).
__host__ __device__ __forceinline__ int edge_src(int j, int n, int mode) {
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

// Geometry of one launch, chosen on the host (plan()).
struct Geo {
  int outer, n0, n1, n2, inner, row_len;
  int k0, k1, k2, lo0, lo1, lo2, taps;
  int run, g0, pos;        // outputs a thread runs along n0; thread groups
                           // along n0; positions a group owns (t1 * chunk)
  int t0, t1, chunk;       // output tile: t0 = g0 * run rows along n0
  int h0, h1, lp;          // box: h0 rows of h1 segments of lp elements
  int flat;                // k2 == 1, chunk == row_len: a box row is one
                           // contiguous piece of h1 * row_len elements
  int vec, mis;            // elements in 16 bytes; the input's address in
                           // elements mod vec
  int seg, rstride, box;   // segment and row strides (congruent to the
                           // source's mod vec), one buffer
  int wpad;                // the generic build's shared-memory weights
  int nb0, nb1, nbc;       // tiles per axis
  long long tiles;
};

template <typename T>
struct Taps {
  T w[kParamBytes / sizeof(T)];
};

template <typename T>
constexpr int param_taps() {
  return kParamBytes / (int)sizeof(T);
}

// Position p of the staged row (relative to the row start, may lie
// outside it) as a row element, mapped along n2; -1 for the fill.
__device__ __forceinline__ int row_src(int p, const Geo& g, int mode) {
  if (p >= 0 && p < g.row_len) return p;
  int i2 = p >= 0 ? p / g.inner : -((-p + g.inner - 1) / g.inner);
  const int ii = p - i2 * g.inner;
  i2 = edge_src(i2, g.n2, mode);
  return i2 < 0 ? -1 : i2 * g.inner + ii;
}

// A tile's position: outer index and tile index along n0, n1 and the row.
struct At {
  int o, b0, b1, bc;
};

__device__ __forceinline__ At split(unsigned v, const Geo& g) {
  At a;
  a.bc = (int)(v % (unsigned)g.nbc);
  v /= (unsigned)g.nbc;
  a.b1 = (int)(v % (unsigned)g.nb1);
  v /= (unsigned)g.nb1;
  a.b0 = (int)(v % (unsigned)g.nb0);
  a.o = (int)(v / (unsigned)g.nb0);
  return a;
}

// a += d in the mixed radix (o, nb0, nb1, nbc); d's digits below their
// radix.
__device__ __forceinline__ void advance(At& a, const At& d, const Geo& g) {
  a.bc += d.bc;
  a.b1 += d.b1;
  a.b0 += d.b0;
  a.o += d.o;
  if (a.bc >= g.nbc) { a.bc -= g.nbc; ++a.b1; }
  if (a.b1 >= g.nb1) { a.b1 -= g.nb1; ++a.b0; }
  if (a.b0 >= g.nb0) { a.b0 -= g.nb0; ++a.o; }
}

// The pieces of a tile's box: h0 x npx pieces of len elements, piece
// position p at line position q0 + p (a line: the plane row of n1 *
// row_len elements when flat, else one row of row_len); positions
// [ia, ib) lie on the line. Piece (r, x) sits at shift + r * rstride +
// x * seg of the buffer; shift is the box origin's source address mod
// 16 bytes, and the strides are congruent to the source's, so that every
// element not mapped by the boundary sits at its source's alignment.
// Items of a piece: the nv 16-byte blocks of the buffer covering
// [ia, ib), kBlocks an item, nsb blocks apart, so that neighbouring
// threads copy neighbouring blocks (a block the window cuts, or whose
// source is not aligned with it, is copied element by element), then the
// nout positions outside the line, one an item.
struct Pieces {
  int npx, len, q0, ia, ib, shift, nv, nsb, nout, items;
};

// The buffer offset of a tile's box: the source element of box position
// (0, 0, 0) (the box's corner before any boundary mapping), counted from
// a 16-byte boundary, mod vec.
__device__ __forceinline__ int box_shift(const At& a, const Geo& g) {
  const long long corner =
      (((long long)a.o * g.n0 + a.b0 * g.t0 - g.lo0) * g.n1 + a.b1 * g.t1 -
       g.lo1) * g.row_len + a.bc * g.chunk - g.lo2 * g.inner;
  return (int)((corner + g.mis) & (g.vec - 1));
}

__device__ __forceinline__ Pieces pieces(const At& a, const Geo& g) {
  Pieces q;
  const int c0 = a.b1 * g.t1 - g.lo1;
  const int s0 = a.bc * g.chunk - g.lo2 * g.inner;
  int line;
  if (g.flat) {
    q.npx = 1;
    q.len = g.h1 * g.row_len;
    q.q0 = c0 * g.row_len;
    line = g.n1 * g.row_len;
  } else {
    q.npx = g.h1;
    q.len = g.lp;
    q.q0 = s0;
    line = g.row_len;
  }
  q.ia = min(max(-q.q0, 0), q.len);
  q.ib = max(min(line - q.q0, q.len), q.ia);
  q.shift = box_shift(a, g);
  q.nv = (q.ib - q.ia + 2 * g.vec - 2) / g.vec;      // any alignment
  q.nsb = (q.nv + kBlocks - 1) / kBlocks;
  q.nout = q.len - (q.ib - q.ia);
  q.items = q.nsb + q.nout;
  return q;
}

// One staging item: piece (r, x), item i.
template <typename T>
__device__ __forceinline__ void stage_item(const T* __restrict__ plane,
                                           T* buf, int r, int x, int i,
                                           const Pieces& q, const At& a,
                                           const Geo& g, int mode, T cval) {
  const int rr = edge_src(a.b0 * g.t0 - g.lo0 + r, g.n0, mode);
  const int c0 = a.b1 * g.t1 - g.lo1;
  T* const d = buf + q.shift + r * g.rstride + x * g.seg;
  const T* line = nullptr;
  bool fill = rr < 0;
  if (!fill) {
    if (g.flat) {
      line = plane + (long long)rr * g.n1 * g.row_len;
    } else {
      const int cc = edge_src(c0 + x, g.n1, mode);
      fill = cc < 0;
      line = plane + ((long long)rr * g.n1 + cc) * g.row_len;
    }
  }
  if (i < q.nsb) {                      // kBlocks 16-byte blocks
    const int a0 = q.ia - (int)((reinterpret_cast<uintptr_t>(d + q.ia) /
                                 sizeof(T)) & (g.vec - 1));
#pragma unroll
    for (int u = 0; u < kBlocks; ++u) {
      const int p = a0 + (u * q.nsb + i) * g.vec;
      const int lo = max(p, q.ia), hi = min(p + g.vec, q.ib);
      if (fill) {
        for (int e = lo; e < hi; ++e) d[e] = cval;
      } else if (lo == p && hi == p + g.vec &&
                 (reinterpret_cast<uintptr_t>(line + q.q0 + p) & 15) == 0) {
        cp_async16(d + p, line + q.q0 + p);
      } else {
        for (int e = lo; e < hi; ++e) cp_async_elem(d + e, line + q.q0 + e);
      }
    }
    return;
  }
  const int j = i - q.nsb;              // a position outside the line
  const int p = j < q.ia ? j : q.ib + (j - q.ia);
  if (fill) {
    d[p] = cval;
    return;
  }
  const T* src;
  if (g.flat) {                         // a column outside [0, n1)
    const int qq = q.q0 + p;
    int xc = qq >= 0 ? qq / g.row_len : -((-qq + g.row_len - 1) / g.row_len);
    const int l = qq - xc * g.row_len;
    xc = edge_src(xc, g.n1, mode);
    if (xc < 0) {
      d[p] = cval;
      return;
    }
    src = line + (long long)xc * g.row_len + l;
  } else {                              // a row position outside the row
    const int s = row_src(q.q0 + p, g, mode);
    if (s < 0) {
      d[p] = cval;
      return;
    }
    src = line + s;
  }
  cp_async_elem(d + p, src);
}

// The walk of a thread over the items (r, x, i) of a tile's pieces:
// its first item and the stride blockDim.x, both as mixed-radix digits.
struct Walk {
  int items, r, x, i, dr, dx, di;
};

__device__ __forceinline__ Walk make_walk(const Pieces& q) {
  Walk w;
  w.items = q.items;
  const int per_row = q.npx * q.items;
  int e = threadIdx.x;
  w.r = e / per_row;
  e -= w.r * per_row;
  w.x = e / q.items;
  w.i = e - w.x * q.items;
  e = blockDim.x;
  w.dr = e / per_row;
  e -= w.dr * per_row;
  w.dx = e / q.items;
  w.di = e - w.dx * q.items;
  return w;
}

// The tile's box into buf: cp.async copies (one commit group is left to
// the caller), constant fills as plain stores. Tiles of one launch share
// the pieces' item count except at the array's edges, so the walk is
// recomputed only when it changes.
template <typename T>
__device__ void stage(const T* __restrict__ in, T* buf, const At& a,
                      const Geo& g, int mode, T cval, Walk& w) {
  const Pieces q = pieces(a, g);
  if (q.items != w.items) w = make_walk(q);
  const T* plane = in + (long long)a.o * g.n0 * g.n1 * g.row_len;
  int r = w.r, x = w.x, i = w.i;
  while (r < g.h0) {
    stage_item(plane, buf, r, x, i, q, a, g, mode, cval);
    i += w.di;
    x += w.dx;
    r += w.dr;
    if (i >= q.items) { i -= q.items; ++x; }
    if (x >= q.npx) { x -= q.npx; ++r; }
  }
}

// Box row r of an unrolled build: its KT = k1 * k2 values read once (at
// the thread's offsets off), added to outputs max(0, r - K0 + 1)..min(r,
// R - 1) (tap row r - y). One instantiation a row, so that the row, the
// outputs and the weights' offsets are compile-time constants whatever
// the unroller decides.
template <typename T, int K0, int KT, int R, int r>
__device__ __forceinline__ void box_row(T (&acc)[R], const T* s,
                                        const int (&off)[KT],
                                        const Taps<T>& taps, const Geo& g) {
  constexpr int ylo = r - K0 + 1 > 0 ? r - K0 + 1 : 0;
  constexpr int yhi = r < R - 1 ? r : R - 1;
  const T* row = s + r * g.rstride;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const T v = row[off[t]];
#pragma unroll
    for (int y = ylo; y <= yhi; ++y)
      acc[y] = acc[y] + v * taps.w[(r - y) * KT + t];
  }
}

template <typename T, int K0, int KT, int R, int... rs>
__device__ __forceinline__ void box_rows(T (&acc)[R], const T* s,
                                         const int (&off)[KT],
                                         const Taps<T>& taps, const Geo& g,
                                         std::integer_sequence<int, rs...>) {
  (box_row<T, K0, KT, R, rs>(acc, s, off, taps, g), ...);
}

// The thread's run: R outputs along n0 from the box column at s (its
// first tap), taps in row-major order per output. K0 > 0: the unrolled
// build of a window of K0 rows of KT = k1 * k2 taps, weights by value at
// immediate offsets. K0 = 0: every count at run time, weights from
// shared memory at ws.
template <typename T, int K0, int KT, int R>
__device__ __forceinline__ void run_taps(const T* s, T* dst, int rows,
                                         long long ostride,
                                         const Taps<T>& taps, const T* ws,
                                         const Geo& g) {
  T acc[R];
#pragma unroll
  for (int y = 0; y < R; ++y) acc[y] = T(-0.0);
  if constexpr (K0 > 0) {
    int off[KT];                         // box offset of row tap t
    int j1 = 0, j2 = 0;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      off[t] = j1 * g.seg + j2 * g.inner;
      if (++j2 == g.k2) {
        j2 = 0;
        ++j1;
      }
    }
    box_rows<T, K0, KT, R>(acc, s, off, taps, g,
                           std::make_integer_sequence<int, R + K0 - 1>());
  } else {
    const int k0 = g.k0, k1 = g.k1, k2 = g.k2, k12 = k1 * k2;
    for (int r = 0; r < R + k0 - 1; ++r) {
      const T* row = s + r * g.rstride;
      const int ylo = r - k0 + 1;        // outputs ylo..r take this row
      int t = r * k12;                   // weight (r - y, j1, j2) at
      for (int j1 = 0; j1 < k1; ++j1) {  // t - y * k12
        for (int j2 = 0; j2 < k2; ++j2, ++t) {
          const T v = row[j1 * g.seg + j2 * g.inner];
#pragma unroll
          for (int y = 0; y < R; ++y)
            if (y >= ylo && y <= r) acc[y] = acc[y] + v * ws[t - y * k12];
        }
      }
    }
  }
#pragma unroll
  for (int y = 0; y < R; ++y)
    if (y < rows) dst[y * ostride] = acc[y];
}

// The unrolled builds keep four blocks an SM in f32 (at most 64 registers
// a thread), three in f64: a register more cost the bench view a third
// of its speed (python -m nd_tpu_torch.scan_sweep stencil); the generic
// build runs faster unbounded.
template <typename T, int K0, int KT, int R>
__global__ void __launch_bounds__(kThreads,
                                  K0 > 0 ? (sizeof(T) == 4 ? 4 : 3) : 1)
    stencil_tiled(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ w, const __grid_constant__ Taps<T> taps,
                  const __grid_constant__ Geo g, int mode, T cval) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ws = reinterpret_cast<T*>(smem);
  T* const box = ws + g.wpad;
  if (K0 == 0)
    for (int i = threadIdx.x; i < g.taps; i += blockDim.x) ws[i] = w[i];
  // the thread's place in every tile
  const int grp = threadIdx.x / g.pos;
  const int at = threadIdx.x - grp * g.pos;
  const int xo = at / g.chunk;
  const int lo = at - xo * g.chunk;
  const int toff = grp * R * g.rstride + xo * g.seg + lo;
  const long long ostride = (long long)g.n1 * g.row_len;
  const long long plane_len = (long long)g.n0 * ostride;
  Walk walk;
  walk.items = -1;
  At cur = split(blockIdx.x, g);
  const At step = split(gridDim.x, g);
  if (cur.o < g.outer) stage(in, box, cur, g, mode, cval, walk);
  cp_async_commit();
  for (int b = 0; cur.o < g.outer; b ^= 1) {
    At nxt = cur;
    advance(nxt, step, g);
    if (nxt.o < g.outer) stage(in, box + (b ^ 1) * g.box, nxt, g, mode, cval,
                               walk);
    cp_async_commit();
    wait_pending(1);
    __syncthreads();
    const int o0 = cur.b0 * g.t0 + grp * R;
    const int o1 = cur.b1 * g.t1 + xo;
    const int col = cur.bc * g.chunk + lo;
    if (grp < g.g0 && o0 < g.n0 && o1 < g.n1 && col < g.row_len) {
      const T* s = box + b * g.box + box_shift(cur, g) + toff;
      T* dst = out + cur.o * plane_len + (long long)o0 * ostride +
               (long long)o1 * g.row_len + col;
      run_taps<T, K0, KT, R>(s, dst, g.n0 - o0, ostride, taps, ws, g);
    }
    __syncthreads();
    cur = nxt;
  }
}

// The windows built with their tap counts known at compile time, one
// build for each (k0, k1 * k2) up to (kRows, kRowTaps) whose weights fit
// the launch parameters.
template <typename T>
bool unrolled(int k0, int k1, int k2) {
  return k0 <= kRows && k1 * k2 <= kRowTaps &&
         k0 * k1 * k2 <= param_taps<T>();
}

// The dynamic shared-memory limit of kernel, raised to the most a launch
// may take once per device (done: the instantiation's own flags, one bit a
// device).
template <typename Kernel>
int raise_smem(Kernel kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (!err) done.fetch_or(bit);
  return err;
}

// The blocks of one build that the card holds at once (SMs times blocks
// an SM, at least one an SM) for a launch's shared memory, remembered per
// device and size.
struct Resident {
  std::mutex lock;
  int dev[16], smem[16], count[16];
  int used = 0, next = 0;

  template <typename Kernel>
  int slots(Kernel kernel, size_t bytes, int* out) {
    int d = 0;
    int err = (int)cudaGetDevice(&d);
    if (err) return err;
    {
      std::lock_guard<std::mutex> hold(lock);
      for (int i = 0; i < used; ++i)
        if (dev[i] == d && smem[i] == (int)bytes) {
          *out = count[i];
          return 0;
        }
    }
    int sms = 0, per_sm = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, d);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, bytes);
    if (err) return err;
    *out = sms * (per_sm > 0 ? per_sm : 1);
    std::lock_guard<std::mutex> hold(lock);
    dev[next] = d;
    smem[next] = (int)bytes;
    count[next] = *out;
    next = (next + 1) % 16;
    if (used < 16) ++used;
    return 0;
  }
};

template <typename T, int K0, int KT, int R>
int launch_tiled(const T* in, T* out, const T* w, const Taps<T>& taps,
                 const Geo& g, int mode, T cval, cudaStream_t stream) {
  auto kernel = stencil_tiled<T, K0, KT, R>;
  static std::atomic<unsigned> raised{0};
  int err = raise_smem(kernel, raised);
  if (err) return err;
  const size_t smem = ((size_t)g.wpad + 2 * (size_t)g.box) * sizeof(T);
  static Resident resident;
  int slots = 0;
  err = resident.slots(kernel, smem, &slots);
  if (err) return err;
  long long blocks = slots;
  if (blocks > g.tiles) blocks = g.tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(in, out, w, taps, g,
                                                        mode, cval);
  return (int)cudaGetLastError();
}

// The unrolled build of (k0, kt), found by walking the builds (K0, KT) in
// order; unrolled<T>(k0, ...) holds.
template <typename T, int R, int K0, int KT>
int launch_unrolled(int k0, int kt, const T* in, T* out, const T* w,
                    const Taps<T>& taps, const Geo& g, int mode, T cval,
                    cudaStream_t s) {
  if constexpr (K0 > kRows) {
    return (int)cudaErrorInvalidValue;
  } else if constexpr (KT > kRowTaps || K0 * KT > param_taps<T>()) {
    return launch_unrolled<T, R, K0 + 1, 1>(k0, kt, in, out, w, taps, g, mode,
                                            cval, s);
  } else {
    if (k0 == K0 && kt == KT)
      return launch_tiled<T, K0, KT, R>(in, out, w, taps, g, mode, cval, s);
    return launch_unrolled<T, R, K0, KT + 1>(k0, kt, in, out, w, taps, g,
                                             mode, cval, s);
  }
}

// The unrolled build of a (k0, kt = k1 * k2) window for which
// unrolled<T>(...) holds, at a run of R outputs; defined where
// ND_STENCIL_GRID is set (the stencil_f*_r*.cu units).
template <typename T, int R>
int launch_grid(int k0, int kt, const T* in, T* out, const T* w,
                const Taps<T>& taps, const Geo& g, int mode, T cval,
                cudaStream_t s)
#ifdef ND_STENCIL_GRID
{
  return launch_unrolled<T, R, 1, 1>(k0, kt, in, out, w, taps, g, mode, cval,
                                     s);
}
#else
    ;
#endif

}  // namespace nd_stencil
