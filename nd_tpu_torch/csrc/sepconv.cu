// Separable VALID correlation over two adjacent axes, with scipy.ndimage
// origin padding and boundary modes rebuilt by index mapping.
//
// Replaces: nd_tpu/ops/conv_pallas.py padless_convolve, rowfused_convolve
// and the two-axis case of separable_convolve_pallas. One kernel covers
// every shape and mode those variants served: the input is viewed as a
// contiguous (outer, n0, n1, inner) array and filtered over n0 (taps t0)
// then n1 (taps t1). The multilook's (y, x, t, 4) cube is
// (1, y, x, t*4); OmnibusTest's stacked (4, y, x, t) cube is (4, y, x, t).
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
// once), then the n1 pass over those column sums. Built with
// -fmad=false, so no multiply-add is contracted and the result is the
// same as the plain PyTorch version's separate operations.

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

}  // extern "C"
