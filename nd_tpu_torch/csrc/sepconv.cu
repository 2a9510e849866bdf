// Separable VALID correlation over two or three adjacent axes, with
// scipy.ndimage origin padding and boundary modes rebuilt by index mapping.
//
// Replaces: nd_tpu/ops/conv_pallas.py padless_convolve, rowfused_convolve
// and separable_convolve_pallas. Two entry points:
//
//  - nd_sepconv_{f32,f64} (two axes; padless, rowfused and the two-axis
//    case of separable_convolve_pallas): the input is viewed as a
//    contiguous (outer, n0, n1, inner) array and filtered over n0 (taps
//    t0) then n1 (taps t1). The multilook's (y, x, t, 4) cube is
//    (1, y, x, t*4); OmnibusTest's stacked (4, y, x, t) cube is
//    (4, y, x, t).
//  - nd_sepconv3_{f32,f64} (the three-axis case of
//    separable_convolve_pallas, temporal taps): the input is viewed as a
//    contiguous (n0, n1, n2, inner) array and filtered as that kernel
//    does: over n2 (taps t2, time) first, then n0 (t0, y), then n1
//    (t1, x). A single-variable (y, x, time) stack is (y, x, t, 1).
//
// Bound on the H100: device-memory bytes. Each output element needs one
// input element and one output element (8 bytes in f32); the k0*k1
// window reads hit L1/L2, because neighbouring threads share them. The
// design keeps the boundary out of device memory: out-of-range positions
// map to in-range sources (or to the fill value) inside the kernel, so no
// padded copy of the cube is ever written. One thread per output
// element, consecutive threads on consecutive `inner` addresses, so every
// load and store is coalesced; the grid's y dimension walks the output
// rows, so the per-element index math is 32-bit.
//
// Numerics: the add order is that of ops.conv._shift_add_valid: per
// source column, the n0 pass (uniform taps are summed first and scaled
// once), then the n1 pass over those column sums; the three-axis entry
// adds the n2 pass innermost. Outside the array the 'constant' mode reads
// cval at the innermost level, and the outer passes run over those
// values, which is the reference's pad-every-axis-then-pass semantics for
// any cval. Built with -fmad=false, so no multiply-add is contracted and
// the result is the same as the plain PyTorch version's separate
// operations.
//
// The three-axis kernel works on output tiles of 16 x 16 (n0, n1)
// positions by a chunk of the contiguous n2*inner row, and keeps both
// partial sums in shared memory: the n2 pass over the tile's (n0, n1)
// halo, then the n0 pass over those, then the n1 pass into the output.
// Every partial sum is computed once per tile instead of once per output
// (k2 + k0 + k1 reads per output plus the halo's share, not k0*k1*k2),
// and each is the very number the per-output loops would form, so the
// add order above is kept.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

enum Mode { kReflect = 0, kMirror = 1, kNearest = 2, kConstant = 3, kWrap = 4 };

template <typename T>
struct Taps {
  T w[kMaxTaps];
  T scale;
  int k;
  int lo;
  int uniform;
  int apply_scale;
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

// Grid: y walks the (outer, n0) output rows, x the n1*inner elements of
// a row (32-bit index math inside a row; the wrapper checks the bound).
template <typename T>
__global__ void sepconv_kernel(const T* __restrict__ in, T* __restrict__ out,
                               long long rows, int n0, int n1, int inner,
                               Taps<T> t0, Taps<T> t1, int mode, T cval) {
  const int row_len = n1 * inner;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long o = row / n0;
    const int i0 = (int)(row - o * n0);
    const T* plane = in + o * n0 * (long long)row_len;
    T* dst = out + row * row_len;
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < row_len;
         col += gridDim.x * blockDim.x) {
      const int i1 = col / inner;
      const int ii = col - i1 * inner;
      T acc = T(0);
      for (int j = 0; j < t1.k; ++j) {
        const int c = edge_src(i1 - t1.lo + j, n1, mode);
        T colsum = T(0);
        for (int i = 0; i < t0.k; ++i) {
          const int r = edge_src(i0 - t0.lo + i, n0, mode);
          const T v = (c < 0 || r < 0)
                          ? cval
                          : plane[(long long)r * row_len + c * inner + ii];
          const T term = t0.uniform ? v : v * t0.w[i];
          colsum = (i == 0) ? term : colsum + term;
        }
        if (t0.apply_scale) colsum = colsum * t0.scale;
        const T term = t1.uniform ? colsum : colsum * t1.w[j];
        acc = (j == 0) ? term : acc + term;
      }
      if (t1.apply_scale) acc = acc * t1.scale;
      dst[col] = acc;
    }
  }
}

constexpr int kTile0 = 16;                 // output tile over n0
constexpr int kTile1 = 16;                 // output tile over n1
constexpr int kThreads3 = 256;
constexpr int kMaxChunk = 32;              // row elements per tile
constexpr int kSmemBudget = 72 * 1024;     // 3 blocks per SM

// Shared-memory bytes per row element of a tile: the n2 pass over the
// (h0, h1) halo and the n0 pass over (kTile0, h1).
template <typename T>
size_t smem_per_elem(int k0, int k1) {
  const size_t h0 = kTile0 + k0 - 1, h1 = kTile1 + k1 - 1;
  return (h0 * h1 + (size_t)kTile0 * h1) * sizeof(T);
}

// One block per tile (grid-stride over tiles): kTile0 x kTile1 (n0, n1)
// outputs by `chunk` consecutive elements of the n2*inner row, consecutive
// threads on consecutive row elements (coalesced loads and stores, no
// shared-memory bank conflicts). Order per output as in the reference: the
// n2 pass, then over the n0 taps, then over the n1 taps.
template <typename T>
__global__ void __launch_bounds__(kThreads3)
    sepconv3_kernel(const T* __restrict__ in, T* __restrict__ out, int n0,
                    int n1, int n2, int inner, int chunk, Taps<T> t0,
                    Taps<T> t1, Taps<T> t2, int mode, T cval) {
  extern __shared__ unsigned char smem[];
  const int h0 = kTile0 + t0.k - 1;
  const int h1 = kTile1 + t1.k - 1;
  T* st = reinterpret_cast<T*>(smem);      // (h0, h1, chunk): n2 pass
  T* sy = st + h0 * h1 * chunk;            // (kTile0, h1, chunk): n0 pass
  const int row_len = n2 * inner;
  const int nb1 = (n1 + kTile1 - 1) / kTile1;
  const int nbc = (row_len + chunk - 1) / chunk;
  const long long tiles =
      (long long)((n0 + kTile0 - 1) / kTile0) * nb1 * nbc;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bc = (int)(tile % nbc);
    const long long rest = tile / nbc;
    const int o0 = (int)(rest / nb1) * kTile0;
    const int o1 = (int)(rest % nb1) * kTile1;
    const int col0 = bc * chunk;

    for (int e = threadIdx.x; e < h0 * h1 * chunk; e += blockDim.x) {
      const int l = e % chunk;
      const int rc = e / chunk;
      const int r = edge_src(o0 - t0.lo + rc / h1, n0, mode);
      const int c = edge_src(o1 - t1.lo + rc % h1, n1, mode);
      const int col = col0 + l;
      T tsum = T(0);
      if (col < row_len) {
        const int i2 = col / inner;
        const int ii = col - i2 * inner;
        const bool fill = r < 0 || c < 0;
        const T* src = fill ? in : in + ((long long)r * n1 + c) * row_len + ii;
        for (int u = 0; u < t2.k; ++u) {
          const int q = edge_src(i2 - t2.lo + u, n2, mode);
          const T v = (fill || q < 0) ? cval : src[(long long)q * inner];
          const T term = t2.uniform ? v : v * t2.w[u];
          tsum = (u == 0) ? term : tsum + term;
        }
        if (t2.apply_scale) tsum = tsum * t2.scale;
      }
      st[e] = tsum;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kTile0 * h1 * chunk; e += blockDim.x) {
      const T* s = st + e;                 // row y of the halo is row y + i
      T ysum = T(0);
      for (int i = 0; i < t0.k; ++i) {
        const T v = s[i * h1 * chunk];
        const T term = t0.uniform ? v : v * t0.w[i];
        ysum = (i == 0) ? term : ysum + term;
      }
      if (t0.apply_scale) ysum = ysum * t0.scale;
      sy[e] = ysum;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kTile0 * kTile1 * chunk; e += blockDim.x) {
      const int l = e % chunk;
      const int yx = e / chunk;
      const int y = yx / kTile1;
      const int x = yx - y * kTile1;
      const int col = col0 + l;
      if (o0 + y >= n0 || o1 + x >= n1 || col >= row_len) continue;
      const T* s = sy + (y * h1 + x) * chunk + l;
      T acc = T(0);
      for (int j = 0; j < t1.k; ++j) {
        const T v = s[j * chunk];
        const T term = t1.uniform ? v : v * t1.w[j];
        acc = (j == 0) ? term : acc + term;
      }
      if (t1.apply_scale) acc = acc * t1.scale;
      out[((long long)(o0 + y) * n1 + (o1 + x)) * row_len + col] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
Taps<T> make_taps(const double* w, int k, int uniform, int apply_scale) {
  Taps<T> t;
  for (int i = 0; i < kMaxTaps; ++i) t.w[i] = T(i < k ? w[i] : 0.0);
  t.k = k;
  t.lo = (k - 1) / 2;
  t.uniform = uniform;
  t.apply_scale = apply_scale;
  t.scale = T(w[0]);
  return t;
}

template <typename T>
int launch(const void* in, void* out, long long outer, int n0, int n1,
           long long inner, const double* w0, int k0, int uniform0,
           int scale0, const double* w1, int k1, int uniform1, int scale1,
           int mode, double cval, void* stream) {
  if (k0 < 1 || k0 > kMaxTaps || k1 < 1 || k1 > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if ((long long)n1 * inner >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long rows = outer * n0;
  const int row_len = n1 * (int)inner;
  if (rows == 0 || row_len == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((row_len + threads - 1) / threads),
                  (unsigned)(rows < 65535 ? rows : 65535));
  sepconv_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, n0, n1,
      (int)inner, make_taps<T>(w0, k0, uniform0, scale0),
      make_taps<T>(w1, k1, uniform1, scale1), mode, T(cval));
  return (int)cudaGetLastError();
}

template <typename T>
int launch3(const void* in, void* out, int n0, int n1, int n2, long long inner,
            const double* w0, int k0, int uniform0, int scale0,
            const double* w1, int k1, int uniform1, int scale1,
            const double* w2, int k2, int uniform2, int scale2, int mode,
            double cval, void* stream) {
  if (k0 < 1 || k0 > kMaxTaps || k1 < 1 || k1 > kMaxTaps || k2 < 1 ||
      k2 > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if ((long long)n2 * inner >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int row_len = n2 * (int)inner;
  if (n0 == 0 || n1 == 0 || row_len == 0) return 0;
  // the longest chunk the budget admits, then evened out over the row
  const size_t per_elem = smem_per_elem<T>(k0, k1);
  int chunk = (int)(kSmemBudget / per_elem);
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int nbc = (row_len + chunk - 1) / chunk;
  chunk = (row_len + nbc - 1) / nbc;
  const long long tiles = (long long)((n0 + kTile0 - 1) / kTile0) *
                          ((n1 + kTile1 - 1) / kTile1) * nbc;
  const size_t smem = per_elem * chunk;
  int err = (int)cudaFuncSetAttribute(
      sepconv3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBudget);
  if (err) return err;
  const unsigned blocks =
      (unsigned)(tiles < (1LL << 30) ? tiles : (1LL << 30));
  sepconv3_kernel<T><<<blocks, kThreads3, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n0, n1, n2, (int)inner,
      chunk, make_taps<T>(w0, k0, uniform0, scale0),
      make_taps<T>(w1, k1, uniform1, scale1),
      make_taps<T>(w2, k2, uniform2, scale2), mode, T(cval));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int nd_sepconv_max_taps() { return kMaxTaps; }

int nd_sepconv_f32(const void* in, void* out, long long outer, int n0, int n1,
                   long long inner, const double* w0, int k0, int uniform0,
                   int scale0, const double* w1, int k1, int uniform1,
                   int scale1, int mode, double cval, void* stream) {
  return launch<float>(in, out, outer, n0, n1, inner, w0, k0, uniform0,
                       scale0, w1, k1, uniform1, scale1, mode, cval, stream);
}

int nd_sepconv_f64(const void* in, void* out, long long outer, int n0, int n1,
                   long long inner, const double* w0, int k0, int uniform0,
                   int scale0, const double* w1, int k1, int uniform1,
                   int scale1, int mode, double cval, void* stream) {
  return launch<double>(in, out, outer, n0, n1, inner, w0, k0, uniform0,
                        scale0, w1, k1, uniform1, scale1, mode, cval, stream);
}

int nd_sepconv3_f32(const void* in, void* out, int n0, int n1, int n2,
                    long long inner, const double* w0, int k0, int uniform0,
                    int scale0, const double* w1, int k1, int uniform1,
                    int scale1, const double* w2, int k2, int uniform2,
                    int scale2, int mode, double cval, void* stream) {
  return launch3<float>(in, out, n0, n1, n2, inner, w0, k0, uniform0, scale0,
                        w1, k1, uniform1, scale1, w2, k2, uniform2, scale2,
                        mode, cval, stream);
}

int nd_sepconv3_f64(const void* in, void* out, int n0, int n1, int n2,
                    long long inner, const double* w0, int k0, int uniform0,
                    int scale0, const double* w1, int k1, int uniform1,
                    int scale1, const double* w2, int k2, int uniform2,
                    int scale2, int mode, double cval, void* stream) {
  return launch3<double>(in, out, n0, n1, n2, inner, w0, k0, uniform0, scale0,
                         w1, k1, uniform1, scale1, w2, k2, uniform2, scale2,
                         mode, cval, stream);
}

}  // extern "C"
