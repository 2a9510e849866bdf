// Non-local means over a (n0, n1, n2, nv) cube, joint over the nv
// variables, with a search window and a patch over any of the three axes.
//
// Replaces: nd_tpu/ops/nlmeans_pallas.py _nlmeans_padless and
// _nlmeans_rowfused (spatial windows, r2 = f2 = 0) and the tiled branch of
// nlmeans_pallas (temporal or full 3-D windows); all three share the body
// _kernel. One kernel takes any shape: the numpy 'reflect' boundary (the
// edge sample is excluded) is rebuilt by index mapping on every axis, the
// third (time) axis included, so no padded copy is written. Axes 0 and 1
// are y and x; axis 2 is time, batched when r2 = f2 = 0.
//
// Bound on the H100: arithmetic and L1 traffic, not device memory. Each
// output evaluates (2r0+1)(2r1+1)(2r2+1)-1 offsets, each a patch distance
// over (2f0+1)(2f1+1)(2f2+1) pixels times nv variables (two loads, a
// subtract and a multiply-add each), then one expf. At r=2/f=2 spatial
// that is 2400 squared differences per output; at r=(2,2,1)/f=1 with 4
// variables about 8000. Device memory sees one read and one write of the
// cube. This first kernel runs one thread per output (y, x, t) and keeps
// the weight sums and the nv accumulators in registers (nv <= 4; wider
// stacks accumulate in the output row). Pair symmetry (one patch distance
// for each +-offset pair) and shared-memory tiles are later work.
//
// Numerics: weight exp(-max(dsq/dsq_norm - 2 sigma^2, 0) / h^2) with
// dsq_norm = nv (2f0+1)(2f1+1)(2f2+1); self-weight wmax (1 where
// wmax == 0) or the n_eff solution. Offsets and patch pixels are visited
// in row-major (axis 0, 1, 2) order, as in the plain PyTorch version.
// Built with -fmad=false, so products and sums round separately; the
// stated tolerance covers the exp implementation.

#include <cuda_runtime.h>

namespace {

// numpy 'reflect' (edge excluded); |j| < 2n - 1 holds because r + f < n
__device__ __forceinline__ int reflect(int j, int n) {
  if (j < 0) return -j;
  if (j >= n) return 2 * n - 2 - j;
  return j;
}

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }

template <typename T>
struct Params {
  int ny, nx, nt, nv;
  int ry, rx, rt, fy, fx, ft;
  T dsq_norm, two_sigma2, inv_h2, n_eff;
  int use_neff;
};

// NV > 0: nv == NV with register accumulators; NV == 0: any nv, the
// output row is the accumulator (each thread owns its row).
template <typename T, int NV>
__global__ void nlmeans_kernel(const T* __restrict__ in, T* __restrict__ out,
                               Params<T> p) {
  const long long total = (long long)p.ny * p.nx * p.nt;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int nv = NV > 0 ? NV : p.nv;
  const long long sx = (long long)p.nt * nv;
  const long long sy = (long long)p.nx * sx;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int t = (int)(idx % p.nt);
    const long long rest = idx / p.nt;
    const int x = (int)(rest % p.nx);
    const int y = (int)(rest / p.nx);
    T* o = out + idx * nv;
    T acc[NV > 0 ? NV : 1];
    if (NV > 0) {
      for (int v = 0; v < NV; ++v) acc[v] = T(0);
    } else {
      for (int v = 0; v < nv; ++v) o[v] = T(0);
    }
    T wsum = T(0), wsq = T(0), wmax = T(0);
    for (int dy = -p.ry; dy <= p.ry; ++dy) {
      for (int dx = -p.rx; dx <= p.rx; ++dx) {
        for (int dt = -p.rt; dt <= p.rt; ++dt) {
          if (dy == 0 && dx == 0 && dt == 0) continue;
          T dsq = T(0);
          for (int py = -p.fy; py <= p.fy; ++py) {
            const T* r1 = in + reflect(y + py, p.ny) * sy;
            const T* r2 = in + reflect(y + dy + py, p.ny) * sy;
            for (int px = -p.fx; px <= p.fx; ++px) {
              const T* c1 = r1 + reflect(x + px, p.nx) * sx;
              const T* c2 = r2 + reflect(x + dx + px, p.nx) * sx;
              for (int pt = -p.ft; pt <= p.ft; ++pt) {
                const T* a = c1 + (long long)reflect(t + pt, p.nt) * nv;
                const T* b = c2 + (long long)reflect(t + dt + pt, p.nt) * nv;
                T sq = T(0);
                for (int v = 0; v < nv; ++v) {
                  const T d = a[v] - b[v];
                  sq = sq + d * d;
                }
                dsq = dsq + sq;
              }
            }
          }
          T g = dsq / p.dsq_norm - p.two_sigma2;
          g = g > T(0) ? g : T(0);
          const T w = exp_t<T>(-g * p.inv_h2);
          wsum = wsum + w;
          if (p.use_neff) {
            wsq = wsq + w * w;
          } else {
            wmax = w > wmax ? w : wmax;
          }
          const T* val = in + reflect(y + dy, p.ny) * sy
                            + reflect(x + dx, p.nx) * sx
                            + (long long)reflect(t + dt, p.nt) * nv;
          if (NV > 0) {
            for (int v = 0; v < NV; ++v) acc[v] = acc[v] + w * val[v];
          } else {
            for (int v = 0; v < nv; ++v) o[v] = o[v] + w * val[v];
          }
        }
      }
    }
    T w_self;
    if (p.use_neff) {
      const T n = p.n_eff;
      const T disc = n * wsum * wsum - n * n * wsq + n * wsq;
      w_self = (wsum + sqrt(disc)) / (n - T(1));
    } else {
      w_self = wmax == T(0) ? T(1) : wmax;
    }
    const T total_w = wsum + w_self;
    const T* center = in + y * sy + x * sx + (long long)t * nv;
    if (NV > 0) {
      for (int v = 0; v < NV; ++v)
        o[v] = (acc[v] + w_self * center[v]) / total_w;
    } else {
      for (int v = 0; v < nv; ++v)
        o[v] = (o[v] + w_self * center[v]) / total_w;
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int ny, int nx, int nt, int nv, int ry,
           int rx, int rt, int fy, int fx, int ft, double sigma, double h,
           double n_eff, void* stream) {
  const long long total = (long long)ny * nx * nt;
  if (total == 0 || nv == 0) return 0;
  Params<T> p;
  p.ny = ny; p.nx = nx; p.nt = nt; p.nv = nv;
  p.ry = ry; p.rx = rx; p.rt = rt; p.fy = fy; p.fx = fx; p.ft = ft;
  p.dsq_norm = T((double)nv * (2 * fy + 1) * (2 * fx + 1) * (2 * ft + 1));
  p.two_sigma2 = T(2.0 * (sigma * sigma));
  p.inv_h2 = T(1.0 / (h * h));
  p.n_eff = T(n_eff);
  p.use_neff = n_eff >= 0.0;
  const int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nv) {
    case 1: nlmeans_kernel<T, 1><<<(unsigned)blocks, threads, 0, s>>>(src, dst, p); break;
    case 2: nlmeans_kernel<T, 2><<<(unsigned)blocks, threads, 0, s>>>(src, dst, p); break;
    case 3: nlmeans_kernel<T, 3><<<(unsigned)blocks, threads, 0, s>>>(src, dst, p); break;
    case 4: nlmeans_kernel<T, 4><<<(unsigned)blocks, threads, 0, s>>>(src, dst, p); break;
    default: nlmeans_kernel<T, 0><<<(unsigned)blocks, threads, 0, s>>>(src, dst, p); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd_nlmeans_f32(const void* in, void* out, int ny, int nx, int nt, int nv,
                   int ry, int rx, int rt, int fy, int fx, int ft,
                   double sigma, double h, double n_eff, void* stream) {
  return launch<float>(in, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft, sigma,
                       h, n_eff, stream);
}

int nd_nlmeans_f64(const void* in, void* out, int ny, int nx, int nt, int nv,
                   int ry, int rx, int rt, int fy, int fx, int ft,
                   double sigma, double h, double n_eff, void* stream) {
  return launch<double>(in, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft,
                        sigma, h, n_eff, stream);
}

}  // extern "C"
