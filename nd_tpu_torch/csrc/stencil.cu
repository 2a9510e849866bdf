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
// the ALREADY-FLIPPED kernel in the input's type, on the device; output
// (o, i0, i1, i2, ii) reads input (o, i0 - lo0 + j0, i1 - lo1 + j1,
// i2 - lo2 + j2, ii) for every tap (j0, j1, j2), lo = (k - 1) / 2, a
// position outside the array mapped by the boundary mode. A two-axis
// filter passes n2 = 1, k2 = 1; ops/conv.py sums three-axis stencils for
// kernels over four or more axes.
//
// Bound on the H100: device-memory bytes for the path's windows (one read
// and one write of each element: 8 bytes in f32 against 2 * taps - 1 f32
// operations, 49 for a 5 x 5 disk, 53 for a 3 x 3 x 3 stencil; the card's
// balance is about 20 operations a byte). The design keeps the window's
// re-reads out of device memory:
//
//  - one block owns an output tile of T0 x T1 (n0, n1) positions by a
//    chunk of the contiguous n2 * inner row; the tile's raw input box,
//    (T0 + k0 - 1) x (T1 + k1 - 1) rows of chunk + (k2 - 1) * inner
//    elements, is staged in shared memory once (cp.async, stage.cuh), with
//    the boundary mapped element by element only on edge tiles;
//  - the weights sit in shared memory beside it (a warp reads one weight
//    as a broadcast);
//  - each thread then forms whole outputs from shared memory, neighbouring
//    threads on neighbouring row elements (no bank conflicts).
// A kernel whose box fits no tile (more taps than about 28,000 in f32)
// takes the direct route: every output from device memory (through L1 and
// L2), weights from device memory.
//
// Numerics: per output one accumulator over the taps in row-major order
// (j0, then j1, then j2), acc = w[0] * x[0], then acc = acc + w[t] * x[t];
// zero weights included (a NaN under a zero weight propagates, as in the
// XLA convolution). Built with -fmad=false, so no multiply-add is
// contracted: the result equals the plain PyTorch version
// (ops/stencil_cuda.py stencil_plain), which does the same products and
// adds in the same order, bit for bit, and the result of an output does
// not depend on the tile it falls in (njobs chunks equal the whole call).

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;       // shared memory a block may use
constexpr int kTileOutputs = 2048;     // outputs a tile aims for

enum Mode { kReflect = 0, kMirror = 1, kNearest = 2, kConstant = 3, kWrap = 4 };

// In-range source index of position j on an axis of n samples under the
// scipy.ndimage boundary mode; -1 means the constant fill (sepconv.cu's
// mapping).
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

// Geometry of one launch, chosen on the host (plan()).
struct Geo {
  int n0, n1, n2, inner, row_len;
  int k0, k1, k2, lo0, lo1, lo2, taps;
  int t0, t1, chunk;       // output tile: (n0, n1) positions by row elems
  int h0, h1, lp;          // staged box: h0 x h1 rows of lp elements
  int wpad;                // weights' shared-memory slots (16-byte aligned)
  int nb0, nb1, nbc;       // tiles per axis
  long long tiles;
};

// Position p of the staged row (relative to the row start, may lie
// outside it) as a row element, mapped along n2; -1 for the fill.
__device__ __forceinline__ int row_src(int p, const Geo& g, int mode) {
  if (p >= 0 && p < g.row_len) return p;
  int i2 = p >= 0 ? p / g.inner : -((-p + g.inner - 1) / g.inner);
  const int ii = p - i2 * g.inner;
  i2 = edge_src(i2, g.n2, mode);
  return i2 < 0 ? -1 : i2 * g.inner + ii;
}

// The tile's raw box into shared memory: cp.async for an interior tile,
// boundary-mapped loads for an edge tile. Box element (r, c, p) is input
// (o, r0 + r, c0 + c, row position s0 + p).
template <typename T>
__device__ void stage_box(const T* __restrict__ plane, T* box, int r0, int c0,
                          int s0, const Geo& g, int mode, T cval) {
  const int n = g.h0 * g.h1 * g.lp;
  const bool interior = r0 >= 0 && r0 + g.h0 <= g.n0 && c0 >= 0 &&
                        c0 + g.h1 <= g.n1 && s0 >= 0 &&
                        s0 + g.lp <= g.row_len;
  if (interior) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int p = e % g.lp;
      const int rc = e / g.lp;
      const int c = rc % g.h1, r = rc / g.h1;
      cp_async_elem(box + e,
                    plane + ((long long)(r0 + r) * g.n1 + (c0 + c)) *
                                g.row_len + (s0 + p));
    }
    return;
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int p = row_src(s0 + e % g.lp, g, mode);
    const int rc = e / g.lp;
    const int c = edge_src(c0 + rc % g.h1, g.n1, mode);
    const int r = edge_src(r0 + rc / g.h1, g.n0, mode);
    box[e] = (p < 0 || c < 0 || r < 0)
                 ? cval
                 : plane[((long long)r * g.n1 + c) * g.row_len + p];
  }
}

// K0, K1, K2 > 0: the tap counts known at compile time (the tap loops
// unroll fully); 0: read from g.
template <typename T, int K0, int K1, int K2>
__global__ void __launch_bounds__(kThreads)
    stencil_tiled(const T* __restrict__ in, T* __restrict__ out,
                  const T* __restrict__ w, Geo g, int mode, T cval) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ws = reinterpret_cast<T*>(smem);
  T* const box = ws + g.wpad;
  const int k0 = K0 > 0 ? K0 : g.k0;
  const int k1 = K1 > 0 ? K1 : g.k1;
  const int k2 = K2 > 0 ? K2 : g.k2;
  for (int i = threadIdx.x; i < g.taps; i += blockDim.x) ws[i] = w[i];
  const int rstride = g.h1 * g.lp;        // box: one n0 row
  const long long plane_len = (long long)g.n0 * g.n1 * g.row_len;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int bc = (int)(tile % g.nbc);
    long long rest = tile / g.nbc;
    const int b1 = (int)(rest % g.nb1);
    rest /= g.nb1;
    const int b0 = (int)(rest % g.nb0);
    const long long o = rest / g.nb0;
    const int o0 = b0 * g.t0, o1 = b1 * g.t1, col0 = bc * g.chunk;
    const T* plane = in + o * plane_len;
    stage_box(plane, box, o0 - g.lo0, o1 - g.lo1, col0 - g.lo2 * g.inner, g,
              mode, cval);
    cp_async_commit();
    wait_pending(0);
    __syncthreads();
    T* const dst = out + o * plane_len;
    const int per_y = g.t1 * g.chunk;
    for (int e = threadIdx.x; e < g.t0 * per_y; e += blockDim.x) {
      const int y = e / per_y;
      const int rem = e - y * per_y;
      const int x = rem / g.chunk;
      const int l = rem - x * g.chunk;
      if (o0 + y >= g.n0 || o1 + x >= g.n1 || col0 + l >= g.row_len) continue;
      const T* s = box + (y * g.h1 + x) * g.lp + l;
      const T* wt = ws;
      T acc = T(0);
#pragma unroll
      for (int j0 = 0; j0 < k0; ++j0) {
#pragma unroll
        for (int j1 = 0; j1 < k1; ++j1) {
#pragma unroll
          for (int j2 = 0; j2 < k2; ++j2) {
            const T term = s[j0 * rstride + j1 * g.lp + j2 * g.inner] * *wt;
            acc = (wt == ws) ? term : acc + term;
            ++wt;
          }
        }
      }
      dst[((long long)(o0 + y) * g.n1 + (o1 + x)) * g.row_len + col0 + l] =
          acc;
    }
    __syncthreads();
  }
}

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
    T acc = T(0);
    int t = 0;
    for (int j0 = 0; j0 < g.k0; ++j0) {
      const int r = edge_src(i0 - g.lo0 + j0, g.n0, mode);
      for (int j1 = 0; j1 < g.k1; ++j1) {
        const int c = edge_src(i1 - g.lo1 + j1, g.n1, mode);
        for (int j2 = 0; j2 < g.k2; ++j2, ++t) {
          const int p = row_src(col + (j2 - g.lo2) * g.inner, g, mode);
          const T v = (r < 0 || c < 0 || p < 0)
                          ? cval
                          : plane[((long long)r * g.n1 + c) * g.row_len + p];
          const T term = v * w[t];
          acc = t == 0 ? term : acc + term;
        }
      }
    }
    out[e] = acc;
  }
}

size_t smem_bytes(const Geo& g, size_t item) {
  return ((size_t)g.wpad + (size_t)g.h0 * g.h1 * g.lp) * item;
}

// The tile: the row chunk splits the row evenly in pieces of at most 64
// elements; T0 = T1 = 8, doubled (up to 32, cut to the axis) while a tile
// has fewer than kTileOutputs outputs (short rows: the stacked variables'
// time axis); then halved, chunk first, until the box fits the shared
// memory. tiles == 0: no tile fits, the direct route.
Geo plan(int outer, int n0, int n1, int n2, int inner, int k0, int k1, int k2,
         size_t item) {
  Geo g{};
  g.n0 = n0; g.n1 = n1; g.n2 = n2; g.inner = inner;
  g.row_len = n2 * inner;
  g.k0 = k0; g.k1 = k1; g.k2 = k2;
  g.lo0 = (k0 - 1) / 2; g.lo1 = (k1 - 1) / 2; g.lo2 = (k2 - 1) / 2;
  g.taps = k0 * k1 * k2;
  const int per16 = (int)(16 / item);
  g.wpad = (g.taps + per16 - 1) / per16 * per16;
  const int nch = (g.row_len + 63) / 64;
  g.chunk = (g.row_len + nch - 1) / nch;
  int side = 8;
  while (side < 32 && side * side * g.chunk < kTileOutputs) side *= 2;
  g.t0 = side < n0 ? side : n0;
  g.t1 = side < n1 ? side : n1;
  for (;;) {
    g.h0 = g.t0 + k0 - 1;
    g.h1 = g.t1 + k1 - 1;
    g.lp = g.chunk + (k2 - 1) * inner;
    if (smem_bytes(g, item) <= (size_t)kSmemMax) break;
    if (g.chunk > 1) {
      g.chunk = (g.chunk + 1) / 2;
    } else if (g.t1 > 1 && g.t1 >= g.t0) {
      g.t1 = (g.t1 + 1) / 2;
    } else if (g.t0 > 1) {
      g.t0 = (g.t0 + 1) / 2;
    } else {
      g.tiles = 0;
      return g;
    }
  }
  g.nb0 = (n0 + g.t0 - 1) / g.t0;
  g.nb1 = (n1 + g.t1 - 1) / g.t1;
  g.nbc = (g.row_len + g.chunk - 1) / g.chunk;
  g.tiles = (long long)outer * g.nb0 * g.nb1 * g.nbc;
  return g;
}

template <typename T, int K0, int K1, int K2>
int launch_tiled(const T* in, T* out, const T* w, const Geo& g, int mode,
                 T cval, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, sizeof(T));
  int err = (int)cudaFuncSetAttribute(
      stencil_tiled<T, K0, K1, K2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = g.tiles < 0x7fffffffLL ? g.tiles : 0x7fffffffLL;
  stencil_tiled<T, K0, K1, K2><<<(unsigned)blocks, kThreads, smem, stream>>>(
      in, out, w, g, mode, cval);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, long long outer, int n0, int n1, int n2,
           long long inner, const void* w, int k0, int k1, int k2, int mode,
           double cval, void* stream) {
  if (k0 < 1 || k1 < 1 || k2 < 1 || mode < 0 || mode > kWrap)
    return (int)cudaErrorInvalidValue;
  if ((long long)n2 * inner >= (1LL << 31) || outer >= (1LL << 31) ||
      (long long)k0 * k1 * k2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (outer == 0 || n0 == 0 || n1 == 0 || n2 * inner == 0) return 0;
  Geo g = plan((int)outer, n0, n1, n2, (int)inner, k0, k1, k2, sizeof(T));
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
  // the path's two windows, unrolled (python -m nd_tpu_torch.scan_sweep
  // stencil times them against the generic build): the 5 x 5 disk over
  // (y, x) and the 3 x 3 x 3 stencil over (y, x, time)
  if (k0 == 5 && k1 == 5 && k2 == 1)
    return launch_tiled<T, 5, 5, 1>(src, dst, wt, g, mode, cv, s);
  if (k0 == 3 && k1 == 3 && k2 == 3)
    return launch_tiled<T, 3, 3, 3>(src, dst, wt, g, mode, cv, s);
  return launch_tiled<T, 0, 0, 0>(src, dst, wt, g, mode, cv, s);
}

}  // namespace

extern "C" {

// The route a launch of these extents takes: 1 tiled, 0 direct.
int nd_stencil_tiled(int n0, int n1, int n2, long long inner, int k0, int k1,
                     int k2, int item) {
  return plan(1, n0, n1, n2, (int)inner, k0, k1, k2, (size_t)item).tiles > 0;
}

int nd_stencil_f32(const void* in, void* out, long long outer, int n0, int n1,
                   int n2, long long inner, const void* w, int k0, int k1,
                   int k2, int mode, double cval, void* stream) {
  return launch<float>(in, out, outer, n0, n1, n2, inner, w, k0, k1, k2, mode,
                       cval, stream);
}

int nd_stencil_f64(const void* in, void* out, long long outer, int n0, int n1,
                   int n2, long long inner, const void* w, int k0, int k1,
                   int k2, int mode, double cval, void* stream) {
  return launch<double>(in, out, outer, n0, n1, n2, inner, w, k0, k1, k2,
                        mode, cval, stream);
}

}  // extern "C"
