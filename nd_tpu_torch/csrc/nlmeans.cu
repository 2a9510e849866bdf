// Non-local means over a (n0, n1, n2, nv) cube, joint over the nv
// variables, with a search window and a patch over any of the three axes.
//
// Replaces: nd_tpu/ops/nlmeans_pallas.py _nlmeans_padless (:408) and
// _nlmeans_rowfused (:271) (spatial windows, r2 = f2 = 0) and the tiled
// branch of nlmeans_pallas (:568, temporal or full 3-D windows); all
// three share the body _kernel (:101), whose algorithm this kernel keeps.
// Axes 0 and 1 are y and x; axis 2 is time, batched when r2 = f2 = 0.
//
// Bound on the H100: arithmetic and shared-memory traffic, not device
// memory (which sees the cube read about three times through the halo
// tiles and written once). Per output and unordered offset pair the work
// is the squared differences of nv variables, three separable patch sums
// and one exp, over a region a little larger than the tile. The design:
//
//  - one block per output tile of ty x tx x tt (y, x, t) positions (the
//    wrapper's _tile_plan picks it from the shapes); for a spatial window
//    the tt slices are batched, since no output reads a neighbouring t;
//  - the halo tile, extent + 2(r+f) per axis and all nv variables, is
//    loaded once into shared memory with the numpy 'reflect' mapping
//    applied at the load; the offset and patch loops are plain shifts
//    inside shared memory with 32-bit offsets, no boundary mapping;
//  - each unordered offset pair D > 0 (row-major over (y, x, t)) is
//    evaluated once, as the Pallas body does: (1) the squared differences
//    summed over v over the D-extended region, (2) the patch sum as
//    separable passes over t, then y, then x through two scratch planes,
//    the last pass turning each patch distance into its weight
//    exp(-max(dsq/dsq_norm - 2 sigma^2, 0)/h^2), once per extended
//    position, (3) each thread adds, for each of its kOut outputs o, the
//    forward weight (pair (o, o+D), the value at o+D) and then the
//    backward one (pair (o-D, o), the value at o-D). Patch distances are
//    symmetric, so the backward term is bit-identical to evaluating -D
//    on its own. wsum, wmax (or wsq for n_eff) and acc[nv] live in
//    registers (nv <= 4; wider stacks accumulate in the output row, which
//    each thread owns).
//
// Wide windows: where the halo tile of every variable fits no block's
// shared memory (4 float32 variables at r = (10, 10, 3), f = 3, or float64
// at r = (5, 5, 5), f = 2, on any tile of 128 outputs), the wrapper's
// _tile_plan sends the call to nlmeans_wide.cu instead; the plan picks
// the kernel from the shapes before the launch.
//
// Numerics: the same operations in the same order as the plain PyTorch
// version (ops/nlmeans.py nlmeans_plain): the squared differences summed
// over v = 0..nv-1, each patch pass adding its 2f+1 terms left to right,
// the division by dsq_norm = nv (2f0+1)(2f1+1)(2f2+1), and per pair the
// forward then the backward terms. Built with -fmad=false, so products
// and sums round separately; only the exp implementation differs.

#include <cuda_runtime.h>

namespace {

constexpr int kOut = 2;              // outputs per thread
constexpr int kSmemMax = 232448;     // shared memory a block may use

template <typename T>
__device__ __forceinline__ T exp_t(T x);
template <>
__device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ double exp_t<double>(double x) { return exp(x); }

// numpy 'reflect' (edge excluded) for the positions a valid output reads
// (|j| < 2n - 1 because r + f < n); positions that only outputs beyond
// the array read are clamped into it.
__device__ __forceinline__ int reflect_src(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * n - 2 - j;
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// e / d for 0 <= e < 2^22 through a float reciprocal, corrected to exact
__device__ __forceinline__ int fdiv(int e, int d, float inv) {
  int q = __float2int_rz(__int2float_rn(e) * inv);
  const int r = e - q * d;
  if (r < 0) --q;
  else if (r >= d) ++q;
  return q;
}

template <typename T>
struct Params {
  int ny, nx, nt, nv;
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

// Shared-memory elements of one block: the halo tile of all nv
// variables and two scratch planes of the largest D-extended region.
__host__ __device__ inline void tile_sizes(int ty, int tx, int tt, int ry,
                                           int rx, int rt, int fy, int fx,
                                           int ft, int nv, long long* tile,
                                           long long* region) {
  *tile = (long long)nv * (ty + 2 * (ry + fy)) * (tx + 2 * (rx + fx)) *
          (tt + 2 * (rt + ft));
  *region = (long long)(ty + ry + 2 * fy) * (tx + rx + 2 * fx) *
            (tt + rt + 2 * ft);
}

// NV > 0: nv == NV with register accumulators; NV == 0: any nv, the
// output row is the accumulator.
template <typename T, int NV>
__global__ void __launch_bounds__(512)
    nlmeans_tiled(const T* __restrict__ in, T* __restrict__ out,
                  Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int nv = NV > 0 ? NV : p.nv;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Py = p.ry + p.fy, Px = p.rx + p.fx, Pt = p.rt + p.ft;
  const int Ey = p.ty + 2 * Py, Ex = p.tx + 2 * Px, Et = p.tt + 2 * Pt;
  const int sX = Et, sY = Ex * Et, sV = Ey * Ex * Et;
  long long tile_n, region_n;
  tile_sizes(p.ty, p.tx, p.tt, p.ry, p.rx, p.rt, p.fy, p.fx, p.ft, nv,
             &tile_n, &region_n);
  T* const bufA = tile + tile_n;
  T* const bufB = bufA + region_n;

  // the block's tile origin; t fastest, then x, then y
  const int nbt = (p.nt + p.tt - 1) / p.tt;
  const int nbx = (p.nx + p.tx - 1) / p.tx;
  int b = blockIdx.x;
  const int t0 = (b % nbt) * p.tt;
  b /= nbt;
  const int x0 = (b % nbx) * p.tx;
  const int y0 = (b / nbx) * p.ty;

  // 1. the halo tile, reflect applied at the load; consecutive threads
  //    read consecutive (t, v) elements of a (y, x) row
  const int row_n = Et * nv;
  for (int e = tid; e < (int)tile_n; e += nth) {
    const int row = e / row_n;
    const int rem = e - row * row_n;
    const int it = rem / nv;
    const int v = rem - it * nv;
    const int iy = row / Ex;
    const int ix = row - iy * Ex;
    const int gy = reflect_src(y0 - Py + iy, p.ny);
    const int gx = reflect_src(x0 - Px + ix, p.nx);
    const int gt = reflect_src(t0 - Pt + it, p.nt);
    tile[v * sV + iy * sY + ix * sX + it] =
        in[(((long long)gy * p.nx + gx) * p.nt + gt) * nv + v];
  }

  // the thread's outputs: (y, x, t) in the tile packed into one int
  // (8 bits each), -1 for none; t fastest across threads
  int opack[kOut], obase[kOut];
  const int nout = p.ty * p.tx * p.tt;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int e = tid + k * nth;
    const int ot = e % p.tt;
    const int oyx = e / p.tt;
    const int ox = oyx % p.tx;
    const int oy = oyx / p.tx;
    const bool ok = e < nout && y0 + oy < p.ny && x0 + ox < p.nx &&
                    t0 + ot < p.nt;
    opack[k] = ok ? (oy << 16) | (ox << 8) | ot : -1;
    obase[k] = (oy + Py) * sY + (ox + Px) * sX + (ot + Pt);
  }

  T acc[kOut][NV > 0 ? NV : 1];
  T wsum[kOut], wx[kOut];            // wx: wsq (n_eff) or wmax
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    wsum[k] = T(0);
    wx[k] = T(0);
    if (NV > 0) {
#pragma unroll
      for (int v = 0; v < (NV > 0 ? NV : 1); ++v) acc[k][v] = T(0);
    } else if (opack[k] >= 0) {
      const int oy = opack[k] >> 16, ox = (opack[k] >> 8) & 255,
                ot = opack[k] & 255;
      T* o = out + (((long long)(y0 + oy) * p.nx + (x0 + ox)) * p.nt +
                    (t0 + ot)) * nv;
      for (int v = 0; v < nv; ++v) o[v] = T(0);
    }
  }
  __syncthreads();

  const int wy = 2 * p.ry + 1, wxn = 2 * p.rx + 1, wt = 2 * p.rt + 1;
  const int npos = wy * wxn * wt;
  for (int pi = npos / 2 + 1; pi < npos; ++pi) {
    const int dt = pi % wt - p.rt;
    const int dx = (pi / wt) % wxn - p.rx;
    const int dy = pi / (wt * wxn) - p.ry;
    const int ady = dy < 0 ? -dy : dy, adx = dx < 0 ? -dx : dx,
              adt = dt < 0 ? -dt : dt;
    const int lo_y = dy > 0 ? -dy : 0, lo_x = dx > 0 ? -dx : 0,
              lo_t = dt > 0 ? -dt : 0;
    const int doff = dy * sY + dx * sX + dt;
    const bool pass_t = p.ft > 0, pass_y = p.fy > 0, pass_x = p.fx > 0;

    // (1) squared differences over the D-extended region widened by f
    int cy = p.ty + ady + 2 * p.fy, cx = p.tx + adx + 2 * p.fx,
        ct = p.tt + adt + 2 * p.ft;
    {
      const int base = (lo_y - p.fy + Py) * sY + (lo_x - p.fx + Px) * sX +
                       (lo_t - p.ft + Pt);
      const bool last = !pass_t && !pass_y && !pass_x;
      const float inv_t = 1.0f / ct, inv_x = 1.0f / cx;
      const int n1 = cy * cx * ct;
      for (int e = tid; e < n1; e += nth) {
        const int q = fdiv(e, ct, inv_t);
        const int it = e - q * ct;
        const int iy = fdiv(q, cx, inv_x);
        const int ix = q - iy * cx;
        // the pair's two positions: variable v at a[v * sV] and b[v * sV]
        const T* a = tile + base + iy * sY + ix * sX + it;
        const T* b = a + doff;
        T d = a[0] - b[0];
        T s = d * d;
#pragma unroll
        for (int v = 1; v < (NV > 0 ? NV : 1); ++v) {
          d = a[v * sV] - b[v * sV];
          s = s + d * d;
        }
        if (NV == 0) {
          for (int v = 1; v < nv; ++v) {
            d = a[v * sV] - b[v * sV];
            s = s + d * d;
          }
        }
        bufA[e] = last ? weight(s, p) : s;
      }
    }
    __syncthreads();
    T* src = bufA;
    T* dst = bufB;

    // (2) separable patch sums: t, then y, then x; the last one weighs
    if (pass_t) {
      const int ct2 = ct - 2 * p.ft;
      const bool last = !pass_y && !pass_x;
      const float inv = 1.0f / ct2;
      const int n2 = cy * cx * ct2;
      for (int e = tid; e < n2; e += nth) {
        const int row = fdiv(e, ct2, inv);
        const T* s = src + row * ct + (e - row * ct2);
        T acc_t = s[0];
        for (int u = 1; u <= 2 * p.ft; ++u) acc_t = acc_t + s[u];
        dst[e] = last ? weight(acc_t, p) : acc_t;
      }
      ct = ct2;
      __syncthreads();
      T* tmp = src; src = dst; dst = tmp;
    }
    if (pass_y) {
      const int cy2 = cy - 2 * p.fy;
      const int plane = cx * ct;
      const bool last = !pass_x;
      const int n2 = cy2 * plane;
      for (int e = tid; e < n2; e += nth) {
        const T* s = src + e;
        T acc_y = s[0];
        for (int u = 1; u <= 2 * p.fy; ++u) acc_y = acc_y + s[u * plane];
        dst[e] = last ? weight(acc_y, p) : acc_y;
      }
      cy = cy2;
      __syncthreads();
      T* tmp = src; src = dst; dst = tmp;
    }
    if (pass_x) {
      const int cx2 = cx - 2 * p.fx;
      const int row_in = cx * ct, row_out = cx2 * ct;
      const float inv = 1.0f / row_out;
      const int n2 = cy * row_out;
      for (int e = tid; e < n2; e += nth) {
        const int iy = fdiv(e, row_out, inv);
        const T* s = src + iy * row_in + (e - iy * row_out);
        T acc_x = s[0];
        for (int u = 1; u <= 2 * p.fx; ++u) acc_x = acc_x + s[u * ct];
        dst[e] = weight(acc_x, p);
      }
      cx = cx2;
      __syncthreads();
      T* tmp = src; src = dst; dst = tmp;
    }
    const T* W = src;                // (ty+|dy|, tx+|dx|, tt+|dt|)

    // (3) forward then backward terms at each of the thread's outputs
    const int fwd0 = -((lo_y * cx + lo_x) * ct + lo_t);
    const int bwd0 = fwd0 - ((dy * cx + dx) * ct + dt);
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      if (opack[k] < 0) continue;
      const int oy = opack[k] >> 16, ox = (opack[k] >> 8) & 255,
                ot = opack[k] & 255;
      const int wi = (oy * cx + ox) * ct + ot;
      T* o = NV > 0 ? nullptr
                    : out + (((long long)(y0 + oy) * p.nx + (x0 + ox)) *
                                 p.nt + (t0 + ot)) * nv;
#pragma unroll
      for (int dir = 0; dir < 2; ++dir) {
        const T w = W[wi + (dir == 0 ? fwd0 : bwd0)];
        const T* val = tile + obase[k] + (dir == 0 ? doff : -doff);
        wsum[k] = wsum[k] + w;
        if (p.use_neff) {
          wx[k] = wx[k] + w * w;
        } else {
          wx[k] = w > wx[k] ? w : wx[k];
        }
        if (NV > 0) {
#pragma unroll
          for (int v = 0; v < (NV > 0 ? NV : 1); ++v)
            acc[k][v] = acc[k][v] + w * val[v * sV];
        } else {
          for (int v = 0; v < nv; ++v) o[v] = o[v] + w * val[v * sV];
        }
      }
    }
    __syncthreads();
  }

  // self-weight and normalisation
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    if (opack[k] < 0) continue;
    const int oy = opack[k] >> 16, ox = (opack[k] >> 8) & 255,
              ot = opack[k] & 255;
    T w_self;
    if (p.use_neff) {
      const T n = p.n_eff;
      const T disc = n * wsum[k] * wsum[k] - n * n * wx[k] + n * wx[k];
      w_self = (wsum[k] + sqrt(disc)) / (n - T(1));
    } else {
      w_self = wx[k] == T(0) ? T(1) : wx[k];
    }
    const T total = wsum[k] + w_self;
    const long long oi =
        (((long long)(y0 + oy) * p.nx + (x0 + ox)) * p.nt + (t0 + ot)) * nv;
    const T* center = tile + obase[k];
    T* o = out + oi;
    if (NV > 0) {
#pragma unroll
      for (int v = 0; v < (NV > 0 ? NV : 1); ++v)
        o[v] = (acc[k][v] + w_self * center[v * sV]) / total;
    } else {
      for (int v = 0; v < nv; ++v)
        o[v] = (o[v] + w_self * center[v * sV]) / total;
    }
  }
}

template <typename T, int NV>
int launch_nv(const T* src, T* dst, const Params<T>& p, long long blocks,
              int threads, size_t smem, cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(
      nlmeans_tiled<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  nlmeans_tiled<T, NV><<<(unsigned)blocks, threads, smem, s>>>(src, dst, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, int ny, int nx, int nt, int nv, int ry,
           int rx, int rt, int fy, int fx, int ft, int ty, int tx, int tt,
           double sigma, double h, double n_eff, void* stream) {
  if ((long long)ny * nx * nt == 0 || nv == 0) return 0;
  // the packed output coordinates take 8 bits per axis
  if (ty < 1 || tx < 1 || tt < 1 || ty > 255 || tx > 255 || tt > 255)
    return (int)cudaErrorInvalidValue;
  const int nout = ty * tx * tt;
  const int threads = ((nout + kOut - 1) / kOut + 31) / 32 * 32;
  if (threads > 512) return (int)cudaErrorInvalidValue;
  long long tile_n, region_n;
  tile_sizes(ty, tx, tt, ry, rx, rt, fy, fx, ft, nv, &tile_n, &region_n);
  const size_t smem = (size_t)(tile_n + 2 * region_n) * sizeof(T);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((ny + ty - 1) / ty) *
                           ((nx + tx - 1) / tx) * ((nt + tt - 1) / tt);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.ny = ny; p.nx = nx; p.nt = nt; p.nv = nv;
  p.ry = ry; p.rx = rx; p.rt = rt; p.fy = fy; p.fx = fx; p.ft = ft;
  p.ty = ty; p.tx = tx; p.tt = tt;
  p.dsq_norm = T((double)nv * (2 * fy + 1) * (2 * fx + 1) * (2 * ft + 1));
  p.two_sigma2 = T(2.0 * (sigma * sigma));
  p.inv_h2 = T(1.0 / (h * h));
  p.n_eff = T(n_eff);
  p.use_neff = n_eff >= 0.0;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nv) {
    case 1: return launch_nv<T, 1>(src, dst, p, blocks, threads, smem, s);
    case 2: return launch_nv<T, 2>(src, dst, p, blocks, threads, smem, s);
    case 3: return launch_nv<T, 3>(src, dst, p, blocks, threads, smem, s);
    case 4: return launch_nv<T, 4>(src, dst, p, blocks, threads, smem, s);
    default: return launch_nv<T, 0>(src, dst, p, blocks, threads, smem, s);
  }
}

}  // namespace

extern "C" {

int nd_nlmeans_f32(const void* in, void* out, int ny, int nx, int nt, int nv,
                   int ry, int rx, int rt, int fy, int fx, int ft, int ty,
                   int tx, int tt, double sigma, double h, double n_eff,
                   void* stream) {
  return launch<float>(in, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft, ty,
                       tx, tt, sigma, h, n_eff, stream);
}

int nd_nlmeans_f64(const void* in, void* out, int ny, int nx, int nt, int nv,
                   int ry, int rx, int rt, int fy, int fx, int ft, int ty,
                   int tx, int tt, double sigma, double h, double n_eff,
                   void* stream) {
  return launch<double>(in, out, ny, nx, nt, nv, ry, rx, rt, fy, fx, ft, ty,
                        tx, tt, sigma, h, n_eff, stream);
}

}  // extern "C"
