// One-axis VALID correlation with a long tap vector over the n axis of a
// contiguous (lines, n, inner) array, with scipy.ndimage origin padding
// and boundary modes rebuilt by index mapping.
//
// Replaces: the per-axis _conv_core of separable_convolve in
// nd_tpu/ops/conv.py (:567, defined at :102): the XLA convolution the
// reference runs for taps past its Pallas kernel's conv_pallas._MAX_TAPS
// (GaussianFilter past sigma 7.8 at truncate 4: 65 taps and more). The
// port's ops/conv.py sends such an axis as one pass over the
// (1, outer, n, inner) view; ops/conv_cuda.py sepconv2 routes every pass
// whose first axis is one unscaled tap and whose second is longer than
// INLINE_TAPS here.
//
// Bound on the H100: arithmetic. A 129-tap pass does 257 f32 operations
// per output against 8 bytes moved; built with -fmad=false, its
// multiplies and adds issue as separate instructions, so half the data
// sheet's 67 TFLOP/s is the ceiling of this bit-equal arithmetic. The
// route it replaces (sepconv_tiled<T, -1, -1> in sepconv.cu) read the
// value and the weight from shared memory for every multiply and add,
// staged a 5 x halo (tiles of at most 32 outputs), and mapped the time
// pass's every position through edge_src. The design:
//
//  - register runs: a thread computes R consecutive outputs along n of
//    one inner column; it slides a window of 2R inputs through registers
//    and, per tap, reads one broadcast weight from shared memory for R
//    multiplies and R adds;
//  - rows (inner >= 32, or lines too long to stage): a block covers nb
//    outputs along n (up to 512) by cb inner columns (a whole row of
//    inner <= 64, else 32: 128-byte coalesced rows), its nb + k - 1 input
//    rows staged once in shared memory with cp.async (16-byte copies
//    where the rows allow), the boundary mapped per row;
//  - lines (inner < 32: the time pass's (lines, 56, 1)): a block stages
//    whole lines, each line's window of ceil(n/R) R + k - 1 positions
//    gathered through an index table in shared memory (edge_src once per
//    position and block; for n < k the window wraps the line several
//    times; cp.async, element by element), threads over (line, column,
//    run) with lines fastest; the outputs go through shared memory so
//    that both copies are coalesced;
//  - the next R window values load one block of R taps ahead.
//
// Numerics: per output the taps add left to right, the first term
// starting the sum; uniform taps are added and scaled once, weighted
// taps multiply each term; multiplies and adds stay separate. The
// result equals the plain version (ops/conv_cuda.py sepconv2_plain) bit
// for bit. 'constant' mode reads cval outside the axis.

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kSmemMax = 232448;       // shared memory a block may use
constexpr int kRowsRun = 16;           // R on the rows route
constexpr int kLinesRun = 8;           // R on the lines route

enum Mode { kReflect = 0, kMirror = 1, kNearest = 2, kConstant = 3, kWrap = 4 };

// In-range source index of position j on an axis of n samples under the
// scipy.ndimage boundary mode; -1 means the constant fill. Positions
// farther out than one period fold periodically.
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

template <typename T>
struct Args {
  long long lines, inner;
  int n, k, lo, mode, per_block, nb;
  int apply_scale, vec;    // vec: rows staged in 16-byte copies
  T scale, cval;
};

// R outputs from a window get(0 .. R + k - 2): taps left to right, the
// first term starting each sum. get(j) for j >= R + k - 1 is never
// used by a tap (the loads past it return 0). The next R window values
// are loaded one block of taps ahead.
template <typename T, int R, bool UNI, typename Get>
__device__ __forceinline__ void run_taps(const Get& get, const T* ws, int k,
                                         T (&acc)[R]) {
  const int last = k + R - 1;
  T win[2 * R], nxt[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    win[q] = get(q);
    nxt[q] = R + q < last ? get(R + q) : T(0);
  }
  const T w0 = UNI ? T(1) : ws[0];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = UNI ? win[r] : win[r] * w0;
  for (int jb = 0; jb < k; jb += R) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      win[R + q] = nxt[q];
      const int j = jb + 2 * R + q;
      nxt[q] = j < last ? get(j) : T(0);
    }
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      const int j = jb + jj;
      if (j >= 1 && j < k) {
        const T w = UNI ? T(1) : ws[j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = acc[r] + (UNI ? win[jj + r] : win[jj + r] * w);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) win[q] = win[R + q];
  }
}

// Rows: block (m, row block, column block), columns fastest; a.per_block
// columns (cb) by a.nb outputs.
template <typename T, bool UNI>
__global__ void __launch_bounds__(256)
    sepconv_long_rows(const T* __restrict__ in, T* __restrict__ out,
                      const T* __restrict__ taps, Args<T> a) {
  constexpr int R = kRowsRun;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb = a.per_block, nb = a.nb, k = a.k;
  const int rows = nb + k - 1;
  T* const S = reinterpret_cast<T*>(smem);      // 16-byte aligned rows
  T* const ws = S + rows * cb;
  const long long ncb = (a.inner + cb - 1) / cb;
  const int nnb = (a.n + nb - 1) / nb;
  long long b = blockIdx.x;
  const long long c0 = (b % ncb) * cb;
  b /= ncb;
  const int i0 = (int)(b % nnb) * nb;
  const long long m = b / nnb;
  const int w = (int)(a.inner - c0 < cb ? a.inner - c0 : cb);  // live columns

  for (int i = threadIdx.x; !UNI && i < k; i += blockDim.x) ws[i] = taps[i];
  // the rows, boundary-mapped per row, copied with cp.async: 16 bytes at a
  // time where the rows allow, else one element
  const T* plane = in + m * a.n * a.inner + c0;
  constexpr int per = 16 / (int)sizeof(T);
  if (a.vec && w == cb) {
    const int chunks = cb / per;
    for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
      const int j = e / chunks;
      const int q = (e - j * chunks) * per;
      const int src = edge_src(i0 - a.lo + j, a.n, a.mode);
      if (src < 0) {
#pragma unroll
        for (int u = 0; u < per; ++u) S[j * cb + q + u] = a.cval;
      } else {
        cp_async16(S + j * cb + q, plane + src * a.inner + q);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cb; e += blockDim.x) {
      const int j = e / cb;
      const int q = e - j * cb;
      const int src = edge_src(i0 - a.lo + j, a.n, a.mode);
      if (q >= w || src < 0)
        S[e] = q >= w ? T(0) : a.cval;
      else
        cp_async_elem(S + e, plane + src * a.inner + q);
    }
  }
  cp_async_commit();
  wait_pending(0);
  __syncthreads();

  const int runs = nb / R;
  for (int item = threadIdx.x; item < runs * cb; item += blockDim.x) {
    const int run = item / cb;
    const int q = item - run * cb;
    if (q >= w || i0 + run * R >= a.n) continue;
    const T* col = S + run * R * cb + q;
    T acc[R];
    run_taps<T, R, UNI>([&](int j) { return col[j * cb]; }, ws, k, acc);
    T* dst = out + (m * a.n + i0 + run * R) * a.inner + c0 + q;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + run * R + r < a.n)
        dst[r * a.inner] = a.apply_scale ? acc[r] * a.scale : acc[r];
    }
  }
}

// Lines: a.per_block whole lines of n * inner elements per block.
template <typename T, bool UNI>
__global__ void __launch_bounds__(512)
    sepconv_long_lines(const T* __restrict__ in, T* __restrict__ out,
                       const T* __restrict__ taps, Args<T> a) {
  constexpr int R = kLinesRun;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.per_block, k = a.k, n = a.n;
  const int C = (int)a.inner;
  const int runs = (n + R - 1) / R;
  const int nw = runs * R + k - 1;               // window positions
  const int ls = (nw * C) | 1, os = (n * C) | 1; // odd line strides
  T* const E = reinterpret_cast<T*>(smem);      // (L, nw * C) windows
  T* const O = E + (long long)L * ls;            // (L, n * C) outputs
  T* const ws = O + (long long)L * os;
  int* const tab = reinterpret_cast<int*>(ws + k);
  const long long m0 = (long long)blockIdx.x * L;
  const int lines = (int)(a.lines - m0 < L ? a.lines - m0 : L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  for (int i = threadIdx.x; !UNI && i < k; i += blockDim.x) ws[i] = taps[i];
  for (int j = threadIdx.x; j < nw; j += blockDim.x)
    tab[j] = edge_src(j - a.lo, n, a.mode);
  __syncthreads();
  // each warp gathers whole lines' windows: consecutive lanes read
  // consecutive (position, column) elements of one line
  for (int line = warp; line < lines; line += warps) {
    const T* src = in + (m0 + line) * n * C;
    T* dst = E + line * ls;
    for (int e = lane; e < nw * C; e += 32) {
      const int j = C == 1 ? e : e / C;
      const int c = e - j * C;
      const int s = tab[j];
      if (s < 0)
        dst[e] = a.cval;
      else
        cp_async_elem(dst + e, src + s * C + c);
    }
  }
  cp_async_commit();
  wait_pending(0);
  __syncthreads();

  for (int item = threadIdx.x; item < runs * C * L; item += blockDim.x) {
    const int line = item % L;
    const int rc = item / L;
    const int c = rc % C, run = rc / C;
    if (line >= lines) continue;
    const T* win = E + line * ls + run * R * C + c;
    T acc[R];
    run_taps<T, R, UNI>([&](int j) { return win[j * C]; }, ws, k, acc);
    T* o = O + line * os + run * R * C + c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (run * R + r < n) o[r * C] = a.apply_scale ? acc[r] * a.scale : acc[r];
    }
  }
  __syncthreads();
  for (int line = warp; line < lines; line += warps) {
    T* dst = out + (m0 + line) * n * C;
    const T* src = O + line * os;
    for (int e = lane; e < n * C; e += 32) dst[e] = src[e];
  }
}

// Shared-memory bytes of a block (the wrapper's long_smem): rows: the
// staged rows, then the weights; lines: the windows, the outputs, the
// weights and the index table.
size_t smem_bytes(int lines_route, int k, int n, long long inner,
                  int per_block, int nb, size_t item) {
  if (lines_route) {
    const long long runs = (n + kLinesRun - 1) / kLinesRun;
    const long long nw = runs * kLinesRun + k - 1;
    const long long ls = (nw * inner) | 1, os = (n * inner) | 1;
    return (size_t)(k + per_block * (ls + os)) * item + (size_t)nw * 4;
  }
  return (size_t)(k + (long long)(nb + k - 1) * per_block) * item;
}

template <typename T, bool UNI>
int launch_route(const T* src, T* dst, const T* taps, const Args<T>& a,
                 int lines_route, long long blocks, int threads, size_t smem,
                 cudaStream_t s) {
  int err;
  if (lines_route) {
    err = (int)cudaFuncSetAttribute(sepconv_long_lines<T, UNI>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    sepconv_long_lines<T, UNI><<<(unsigned)blocks, threads, smem, s>>>(
        src, dst, taps, a);
  } else {
    err = (int)cudaFuncSetAttribute(sepconv_long_rows<T, UNI>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    sepconv_long_rows<T, UNI><<<(unsigned)blocks, threads, smem, s>>>(
        src, dst, taps, a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, long long lines, int n,
           long long inner, const void* taps, int k, int uniform,
           int apply_scale, double scale, int mode, double cval,
           int lines_route, int per_block, int nb, int threads,
           void* stream) {
  if (lines == 0 || n == 0 || inner == 0) return 0;
  if (k < 1 || (!uniform && taps == nullptr) || per_block < 1 ||
      threads < 32 || threads % 32 || mode < kReflect || mode > kWrap)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * inner >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long blocks;
  if (lines_route) {
    if (threads > 512 || inner >= 32) return (int)cudaErrorInvalidValue;
    blocks = (lines + per_block - 1) / per_block;
  } else {
    if (threads > 256 || nb < kRowsRun || nb % kRowsRun ||
        (long long)(nb + k - 1) * per_block >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    blocks = lines * ((n + nb - 1) / nb) * ((inner + per_block - 1) / per_block);
  }
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(lines_route, k, n, inner, per_block, nb, sizeof(T));
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.lines = lines; a.inner = inner; a.n = n; a.k = k; a.lo = (k - 1) / 2;
  a.mode = mode; a.per_block = per_block; a.nb = nb;
  a.apply_scale = apply_scale; a.scale = T(scale); a.cval = T(cval);
  // 16-byte row copies: an aligned input, rows and column blocks of whole
  // 16-byte chunks
  constexpr int per = 16 / (int)sizeof(T);
  a.vec = (reinterpret_cast<unsigned long long>(in) & 15) == 0 &&
          inner % per == 0 && per_block % per == 0;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const T* w = static_cast<const T*>(taps);
  cudaStream_t s = (cudaStream_t)stream;
  if (uniform)
    return launch_route<T, true>(src, dst, w, a, lines_route, blocks, threads,
                                 smem, s);
  return launch_route<T, false>(src, dst, w, a, lines_route, blocks, threads,
                                smem, s);
}

}  // namespace

extern "C" {

// taps: the k weights as the kernel's type on the device (unread for
// uniform taps, which are added and scaled by `scale` where apply_scale);
// lines_route: 1 for whole lines (per_block lines a block), 0 for rows
// (per_block columns by nb outputs a block).
int nd_sepconv_long_f32(const void* in, void* out, long long lines, int n,
                        long long inner, const void* taps, int k, int uniform,
                        int apply_scale, double scale, int mode, double cval,
                        int lines_route, int per_block, int nb, int threads,
                        void* stream) {
  return launch<float>(in, out, lines, n, inner, taps, k, uniform,
                       apply_scale, scale, mode, cval, lines_route, per_block,
                       nb, threads, stream);
}

int nd_sepconv_long_f64(const void* in, void* out, long long lines, int n,
                        long long inner, const void* taps, int k, int uniform,
                        int apply_scale, double scale, int mode, double cval,
                        int lines_route, int per_block, int nb, int threads,
                        void* stream) {
  return launch<double>(in, out, lines, n, inner, taps, k, uniform,
                        apply_scale, scale, mode, cval, lines_route,
                        per_block, nb, threads, stream);
}

}  // extern "C"
