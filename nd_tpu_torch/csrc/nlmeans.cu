// Non-local means over a (n0, n1, n2, nv) cube, joint over the nv
// variables, with a search window and a patch over any of the three axes.
//
// Replaces: nd_tpu/ops/nlmeans_pallas.py _nlmeans_padless (:408) and
// _nlmeans_rowfused (:271) (spatial windows, r2 = f2 = 0) and the tiled
// branch of nlmeans_pallas (:568, temporal or full 3-D windows); all
// three share the body _kernel (:101), whose arithmetic this kernel keeps.
// Axes 0 and 1 are y and x; axis 2 is time, batched when r2 = f2 = 0.
//
// Bound on the H100: instruction issue. Per output and unordered offset
// pair the work is the squared differences of nv variables over the
// patch positions evaluated, three separable patch sums, one IEEE
// division and one expf per weight, and the two weighted adds: about 80
// issued instructions a pair and output in nlmeans_ring_pairs at a
// spatial r=2/f=1 window, 220 in nlmeans_ring at r=(2,2,1)/f=1 (SASS of
// the offset loop). Shared loads (3 a position evaluated) come next;
// device memory sees the cube read about 1.5-3 times through the halo
// tiles and written once. The design, a register-resident offset loop:
//
//  - one block per output tile of ty x tx x tt (y, x, t) positions (the
//    wrapper's _tile_plan picks it from the shapes); the halo tile is
//    copied once into shared memory (cp.async, every copy of the block
//    in flight) with the numpy 'reflect' mapping applied at the copy, the
//    nv values of a position side by side (one 16-byte load for 4
//    float32) and x fastest, so the 32 lanes of a warp read 32
//    consecutive positions;
//  - a warp owns 32 consecutive x positions, one a lane; the inner tx
//    are outputs, the others the halo of the x pass. Each thread owns a
//    run of R outputs along y (the walk axis) at C consecutive t: R = 8,
//    C = 1 where the patch has no t extent (the t slices batched over
//    warps), else R = 4, C = 2 (4 x 4 holds twice the registers and
//    halves the warps a multiprocessor keeps: slower on the card);
//  - nlmeans_ring, every window whose patch radii fit: per unordered
//    offset pair D > 0 (row-major over (y, x, t)) each thread evaluates
//    both directions at its own outputs, in registers: at each row of
//    its run and fy rows on each side and each of its columns and ft on
//    each side, the squared differences to the position + D and to the
//    position - D (one load of the position serves both), then per row
//    the t pass over its columns, per output the y pass over its rows and
//    the x pass by warp shuffles, one weight per output and direction,
//    and the forward then the backward term added to its accumulators.
//    Patch distances are symmetric (a - b and b - a square to the same
//    bits), so the backward weight evaluated at o with -D is
//    bit-identical to the forward weight of the pair (o - D, o) that the
//    Pallas body reuses. tx = 32 - 2fx;
//  - nlmeans_ring_pairs, spatial windows of 4 float32 variables at fy =
//    fx = 1 or 2 (the README chain, r <= 2): each pair's weight evaluated
//    once, at the pair's left position, for the R + dy rows its outputs'
//    two directions use; the backward weight of output o comes from the
//    lane dx to the left by shuffle, so tx = 32 - 2(rx + fx). A weight
//    is 25 of the about 50 instructions of a direction;
//  - no scratch plane, no barrier and no index division inside the
//    offset loop; builds with every radius fixed at compile time (float32
//    nv = 4: the pair kernel at fy = fx = 1, 2; nlmeans_ring at f = 1 on
//    each axis), each with and without n_eff, wsum, wmax (or wsq) and
//    acc[4] in registers; every other shape the tile plan sends here
//    (float64, any nv, fy and ft up to kFMax, fx up to kFxMax) in
//    nlmeans_ring's generic build with runtime radii, the output row its
//    accumulator.
//
// Wide windows: where the halo tile of every variable fits no block's
// shared memory, or a patch radius passes kFMax or kFxMax, the wrapper's
// _tile_plan sends the call to nlmeans_wide.cu instead; the plan picks
// the kernel from the shapes before the launch.
//
// Numerics: the same operations in the same order as the plain PyTorch
// version (ops/nlmeans.py nlmeans_plain): the squared differences
// summed over v = 0..nv-1, the patch passes over t, then y, then x, each
// adding its 2f+1 terms left to right, the IEEE division by dsq_norm =
// nv (2f0+1)(2f1+1)(2f2+1) and expf (no fast-math intrinsic), the pairs
// in row-major order and per pair the forward then the backward term,
// the self-weight and the normalisation. Built with -fmad=false, so
// products and sums round separately; only the exp implementation
// differs from the plain version's.

#include <cuda_runtime.h>

#include <cstdint>

#include "stage.cuh"

namespace {

constexpr int kSmemMax = 232448;     // shared memory a block may use
constexpr int kFMax = 3;             // largest fy and ft of the generic builds
constexpr int kFxMax = 8;            // largest fx: 16 outputs of a warp
constexpr int kMaxThreads = 256;
constexpr int kPairRMax = 2;         // largest ry of the pair kernel's builds
constexpr unsigned kAll = 0xffffffffu;

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
  int aligned16;                     // the input's positions 16-byte aligned
};

template <typename T>
__device__ __forceinline__ T weight(T patch, const Params<T>& p) {
  T g = patch / p.dsq_norm - p.two_sigma2;
  g = g < T(0) ? T(0) : g;           // NaN stays NaN, as clamp_min
  return exp_t<T>(-g * p.inv_h2);
}

// one position's NV values from shared memory
template <typename T, int NV>
__device__ __forceinline__ void load_rec(const T* s, T (&r)[NV]) {
  if constexpr (NV == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (NV == 4 && sizeof(T) == 8) {
    const double2 a = reinterpret_cast<const double2*>(s)[0];
    const double2 b = reinterpret_cast<const double2*>(s)[1];
    r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
  } else {
#pragma unroll
    for (int v = 0; v < NV; ++v) r[v] = s[v];
  }
}

template <typename T, int NV>
__device__ __forceinline__ T sqsum(const T (&a)[NV], const T (&b)[NV]) {
  T d = a[0] - b[0];
  T s = d * d;
#pragma unroll
  for (int v = 1; v < NV; ++v) {
    d = a[v] - b[v];
    s = s + d * d;
  }
  return s;
}

// The block's output tile (t fastest, then x, then y) and its halo tile
// in shared memory: ty + 2(ry+fy) rows, 32 + 2rx positions along x (the
// warp's 32 lanes, lx = (32 - tx) / 2 of them before the first output,
// and rx on each side) and tt + 2(rt+ft) along t, the numpy 'reflect'
// mapping applied at the load; x fastest, then y, then t, the nv values
// of a position side by side. Consecutive threads copy consecutive t of
// a (y, x) row, every copy of the block in flight at once (cp.async, 16
// bytes a position where the input allows it).
struct Halo {
  int y0, x0, t0;                    // the block's first output
  int sY, sT;                        // element strides of a row and a plane
};

template <typename T, int NV>
__device__ __forceinline__ Halo load_halo(const T* __restrict__ in, T* tile,
                                          const Params<T>& p, int fy,
                                          int ft) {
  const int nv = NV > 0 ? NV : p.nv;
  Halo h;
  const int nbt = (p.nt + p.tt - 1) / p.tt;
  const int nbx = (p.nx + p.tx - 1) / p.tx;
  int b = blockIdx.x;
  h.t0 = (b % nbt) * p.tt;
  b /= nbt;
  h.x0 = (b % nbx) * p.tx;
  h.y0 = (b / nbx) * p.ty;
  const int Py = p.ry + fy, Px = (32 - p.tx) / 2 + p.rx, Pt = p.rt + ft;
  const int Ey = p.ty + 2 * Py, Ex = 32 + 2 * p.rx, Et = p.tt + 2 * Pt;
  h.sY = Ex * nv;
  h.sT = Ey * Ex * nv;
  const int nrec = Ey * Ex * Et;
  const float inv_t = 1.0f / Et, inv_x = 1.0f / Ex;
  for (int e = threadIdx.x; e < nrec; e += blockDim.x) {
    const int q = fdiv(e, Et, inv_t);
    const int it = e - q * Et;
    const int iy = fdiv(q, Ex, inv_x);
    const int ix = q - iy * Ex;
    const int gy = reflect_src(h.y0 - Py + iy, p.ny);
    const int gx = reflect_src(h.x0 - Px + ix, p.nx);
    const int gt = reflect_src(h.t0 - Pt + it, p.nt);
    const T* src = in + (((long long)gy * p.nx + gx) * p.nt + gt) * nv;
    T* dst = tile + it * h.sT + iy * h.sY + ix * nv;
    if (NV * sizeof(T) == 16 && p.aligned16) {
      cp_async16(dst, src);
    } else {
      for (int v = 0; v < nv; ++v) cp_async_elem(dst + v, src + v);
    }
  }
  cp_async_commit();
  wait_pending(0);
  return h;
}

// one weighted term: wsum, wx (wsq for n_eff, else wmax) and acc; NE
// fixes whether n_eff is in use (-1: p says)
template <typename T, int NV, int NE>
__device__ __forceinline__ void add_term(T w, const T (&val)[NV], T& wsum,
                                         T& wx, T (&acc)[NV],
                                         const Params<T>& p) {
  wsum = wsum + w;
  if (NE >= 0 ? NE == 1 : p.use_neff) {
    wx = wx + w * w;
  } else {
    wx = w > wx ? w : wx;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = acc[v] + w * val[v];
}

// the self-weight and normalisation of one output: o = (acc + w_self
// center) / (wsum + w_self), acc being the output row itself for NV == 0
template <typename T, int NV>
__device__ __forceinline__ void finish(T wsum, T wx, const T* acc,
                                       const T* center, T* o,
                                       const Params<T>& p) {
  const int nv = NV > 0 ? NV : p.nv;
  T w_self;
  if (p.use_neff) {
    const T n = p.n_eff;
    const T disc = n * wsum * wsum - n * n * wx + n * wx;
    w_self = (wsum + sqrt(disc)) / (n - T(1));
  } else {
    w_self = wx == T(0) ? T(1) : wx;
  }
  const T total = wsum + w_self;
  if constexpr (NV == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(o) =
        make_float4((acc[0] + w_self * center[0]) / total,
                    (acc[1] + w_self * center[1]) / total,
                    (acc[2] + w_self * center[2]) / total,
                    (acc[3] + w_self * center[3]) / total);
  } else {
    for (int v = 0; v < nv; ++v) o[v] = (acc[v] + w_self * center[v]) / total;
  }
}

// Every window whose patch radii fit: each pair's two directions
// evaluated at the thread's own outputs. NV > 0: nv == NV with register
// accumulators; NV == 0: any nv, the output row is the accumulator. FY,
// FX, FT >= 0 fix the patch radii; -1 takes them from p (fy, ft <= kFMax,
// fx <= kFxMax); NE as add_term's. R x C outputs a thread: R along y, C
// along t; the lanes fx .. 31 - fx are outputs (tx = 32 - 2fx).
template <typename T, int NV, int FY, int FX, int FT, int R, int C, int NE>
__global__ void __launch_bounds__(kMaxThreads)
    nlmeans_ring(const T* __restrict__ in, T* __restrict__ out,
                 Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int FYM = FY >= 0 ? FY : kFMax;
  constexpr int FTM = FT >= 0 ? FT : kFMax;
  constexpr int NR = R + 2 * FYM;    // rows of a run and its patch halo
  constexpr int NC = C + 2 * FTM;    // columns and their patch halo
  constexpr int NA = NV > 0 ? NV : 1;
  const int nv = NV > 0 ? NV : p.nv;
  const int fy = FY >= 0 ? FY : p.fy;
  const int fx = FX >= 0 ? FX : p.fx;
  const int ft = FT >= 0 ? FT : p.ft;
  const Halo h = load_halo<T, NV>(in, tile, p, fy, ft);
  const int sY = h.sY, sT = h.sT;

  // the thread: its lane along x, its warp's run (wy) and columns (wt)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwt = p.tt / C;
  const int wy = warp / nwt, wt = warp - wy * nwt;
  const int gx = h.x0 - fx + lane;
  const int gy0 = h.y0 + wy * R, gt0 = h.t0 + wt * C;  // its first output
  // the halo tile's element at (y, x, t) = (gy0 - fy, gx, gt0 - ft):
  // row 0 and column 0 of the positions the thread evaluates
  const int base = (wt * C + p.rt) * sT + (wy * R + p.ry) * sY +
                   (p.rx + lane) * nv;
  unsigned valid = 0;                // bit k * C + c: output (k, c) exists
  if (lane >= fx && lane < 32 - fx && gx < p.nx) {
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (gy0 + k < p.ny && gt0 + c < p.nt) valid |= 1u << (k * C + c);
  }

  T acc[R][C][NA];
  T wsum[R][C], wx[R][C];            // wx: wsq (n_eff) or wmax
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      wsum[k][c] = T(0);
      wx[k][c] = T(0);
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[k][c][v] = T(0);
      if (NV == 0 && (valid >> (k * C + c) & 1u)) {
        T* o = out + (((long long)(gy0 + k) * p.nx + gx) * p.nt +
                      (gt0 + c)) * nv;
        for (int v = 0; v < nv; ++v) o[v] = T(0);
      }
    }
  __syncthreads();

  const int npairs =
      ((2 * p.ry + 1) * (2 * p.rx + 1) * (2 * p.rt + 1) - 1) / 2;
  int dy = 0, dx = 0, dt = 0;
  for (int pi = 0; pi < npairs; ++pi) {
    // the next offset after the last, row-major over (y, x, t)
    if (++dt > p.rt) {
      dt = -p.rt;
      if (++dx > p.rx) {
        dx = -p.rx;
        ++dy;
      }
    }
    const int doff = dt * sT + dy * sY + dx * nv;
    T ptf[NR][C], ptb[NR][C];        // each row's t pass, both directions
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (j < R + 2 * fy) {
        // (1) squared differences at row j, forward and backward
        T sf[NC], sb[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          if (cc < C + 2 * ft) {
            const T* a = tile + base + cc * sT + j * sY;
            if constexpr (NV > 0) {
              T ca[NV], fa[NV], ba[NV];
              load_rec<T, NV>(a, ca);
              load_rec<T, NV>(a + doff, fa);
              load_rec<T, NV>(a - doff, ba);
              sf[cc] = sqsum<T, NV>(ca, fa);
              sb[cc] = sqsum<T, NV>(ca, ba);
            } else {
              T d = a[0] - a[doff];
              T s = d * d;
              T e = a[0] - a[-doff];
              T u = e * e;
              for (int v = 1; v < nv; ++v) {
                d = a[v] - a[doff + v];
                s = s + d * d;
                e = a[v] - a[v - doff];
                u = u + e * e;
              }
              sf[cc] = s;
              sb[cc] = u;
            }
          }
        }
        // (2) the t pass over the row's columns
#pragma unroll
        for (int c = 0; c < C; ++c) {
          T af = sf[c], ab = sb[c];
#pragma unroll
          for (int u = 1; u <= 2 * FTM; ++u) {
            if (u <= 2 * ft) {
              af = af + sf[c + u];
              ab = ab + sb[c + u];
            }
          }
          ptf[j][c] = af;
          ptb[j][c] = ab;
        }
      }
      // the output row whose patch ends at row j (at the largest fy)
      if (j >= 2 * FYM) {
        const int k = j - 2 * FYM;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // (3) the y pass over the rows, the x pass across the lanes
          T yf = ptf[k][c], yb = ptb[k][c];
#pragma unroll
          for (int u = 1; u <= 2 * FYM; ++u) {
            if (u <= 2 * fy) {
              yf = yf + ptf[k + u][c];
              yb = yb + ptb[k + u][c];
            }
          }
          T xf = yf, xb = yb;
          if (fx > 0) {
            xf = __shfl_sync(kAll, yf, lane - fx);
            xb = __shfl_sync(kAll, yb, lane - fx);
            for (int u = 1; u <= 2 * fx; ++u) {
              xf = xf + (u == fx ? yf : __shfl_sync(kAll, yf, lane - fx + u));
              xb = xb + (u == fx ? yb : __shfl_sync(kAll, yb, lane - fx + u));
            }
          }
          // (4) the weights, the forward then the backward term
          const T w2[2] = {weight(xf, p), weight(xb, p)};
          const T* ctr = tile + base + (c + ft) * sT + (k + fy) * sY;
#pragma unroll
          for (int dir = 0; dir < 2; ++dir) {
            const T* vp = ctr + (dir == 0 ? doff : -doff);
            if constexpr (NV > 0) {
              T val[NV];
              load_rec<T, NV>(vp, val);
              add_term<T, NV, NE>(w2[dir], val, wsum[k][c], wx[k][c],
                                  acc[k][c], p);
            } else {
              const T w = w2[dir];
              wsum[k][c] = wsum[k][c] + w;
              if (p.use_neff) {
                wx[k][c] = wx[k][c] + w * w;
              } else {
                wx[k][c] = w > wx[k][c] ? w : wx[k][c];
              }
              if (valid >> (k * C + c) & 1u) {
                T* o = out + (((long long)(gy0 + k) * p.nx + gx) * p.nt +
                              (gt0 + c)) * nv;
                for (int v = 0; v < nv; ++v) o[v] = o[v] + w * vp[v];
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!(valid >> (k * C + c) & 1u)) continue;
      T* o = out + (((long long)(gy0 + k) * p.nx + gx) * p.nt + (gt0 + c)) *
                       nv;
      finish<T, NV>(wsum[k][c], wx[k][c], NV > 0 ? acc[k][c] : o,
                    tile + base + (c + ft) * sT + (k + fy) * sY, o, p);
    }
}

// One row of offsets (a fixed dy = DY) of the pair kernel: for each dx,
// the weights of the pairs (q, q + D) at the R + DY positions q of the
// thread's column that its outputs' two directions use, each once.
template <int FY, int FX, int R, int NE, int DY>
__device__ __forceinline__ void pair_row(const float* tile, int base, int sY,
                                         int lane, const Params<float>& p,
                                         float (&acc)[R][4], float (&wsum)[R],
                                         float (&wx)[R]) {
  constexpr int E = R + DY;          // weights: rows gy0 - DY .. gy0 + R - 1
  constexpr int NS = E + 2 * FY;     // their patch rows
  for (int dx = DY == 0 ? 1 : -p.rx; dx <= p.rx; ++dx) {
    const int doff = DY * sY + dx * 4;
    float S[NS], W[E], keep[R][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // (1) the squared differences at row j: y = gy0 - DY - FY + j
      const float* a = tile + base + (j - DY) * sY;
      float ca[4], fa[4];
      load_rec<float, 4>(a, ca);
      load_rec<float, 4>(a + doff, fa);
      S[j] = sqsum<float, 4>(ca, fa);
      if (j >= DY + FY && j < DY + FY + R) {
#pragma unroll
        for (int v = 0; v < 4; ++v) keep[j - DY - FY][v] = fa[v];
      }
      if (j >= 2 * FY) {
        // (2) the weight of row e = j - 2FY: the y pass, the x pass
        const int e = j - 2 * FY;
        float py = S[e];
#pragma unroll
        for (int u = 1; u <= 2 * FY; ++u) py = py + S[e + u];
        float px = __shfl_sync(kAll, py, lane - FX);
#pragma unroll
        for (int u = 1; u <= 2 * FX; ++u)
          px = px + (u == FX ? py : __shfl_sync(kAll, py, lane - FX + u));
        W[e] = weight(px, p);
        if (e >= DY) {
          // (3) output k = e - DY: the forward term (its pair (o, o + D)),
          //     then the backward one (the pair (o - D, o), weighed at
          //     o - D by the lane dx to the left)
          const int k = e - DY;
          const float wb = __shfl_sync(kAll, W[k], lane - dx);
          float vb[4];
          load_rec<float, 4>(tile + base + (k + FY) * sY - doff, vb);
          add_term<float, 4, NE>(W[e], keep[k], wsum[k], wx[k], acc[k], p);
          add_term<float, 4, NE>(wb, vb, wsum[k], wx[k], acc[k], p);
        }
      }
    }
  }
  if constexpr (DY < kPairRMax) {
    if (DY < p.ry)
      pair_row<FY, FX, R, NE, DY + 1>(tile, base, sY, lane, p, acc, wsum,
                                      wx);
  }
}

// Spatial windows (r2 = f2 = 0) of 4 float32 variables at the patch radii
// FY, FX: each pair's weight evaluated once, at the pair's left position,
// for both its directions. R outputs a thread along y at one t; the lanes
// rx + fx .. 31 - rx - fx are outputs (tx = 32 - 2(rx + fx)), so that the
// lane dx to the left of each holds a weight.
template <int FY, int FX, int R, int NE>
__global__ void __launch_bounds__(kMaxThreads)
    nlmeans_ring_pairs(const float* __restrict__ in, float* __restrict__ out,
                  Params<float> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);
  const Halo h = load_halo<float, 4>(in, tile, p, FY, 0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wy = warp / p.tt, wt = warp - wy * p.tt;
  const int lx = p.rx + FX;          // lanes before the first output
  const int gx = h.x0 - lx + lane;
  const int gy0 = h.y0 + wy * R, gt = h.t0 + wt;
  // the halo tile's element at (y, x, t) = (gy0 - FY, gx, gt)
  const int base = wt * h.sT + (wy * R + p.ry) * h.sY + (p.rx + lane) * 4;
  float acc[R][4], wsum[R], wx[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    wsum[k] = 0.0f;
    wx[k] = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[k][v] = 0.0f;
  }
  __syncthreads();
  pair_row<FY, FX, R, NE, 0>(tile, base, h.sY, lane, p, acc, wsum, wx);
  if (lane < lx || lane >= 32 - lx || gx >= p.nx || gt >= p.nt) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (gy0 + k >= p.ny) continue;
    float* o = out + (((long long)(gy0 + k) * p.nx + gx) * p.nt + gt) * 4;
    finish<float, 4>(wsum[k], wx[k], acc[k], tile + base + (k + FY) * h.sY,
                     o, p);
  }
}

template <typename T>
int launch_with(void (*kernel)(const T*, T*, Params<T>), unsigned blocks,
                int threads, size_t smem, cudaStream_t s, const T* src,
                T* dst, const Params<T>& p) {
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kernel<<<blocks, threads, smem, s>>>(src, dst, p);
  return (int)cudaGetLastError();
}

// whether the pair kernel has a build for the shapes (pair_build in
// ops/nlmeans_cuda.py)
__host__ inline bool pair_build(int nv, int itemsize, int ry, int rx, int rt,
                                int fy, int fx, int ft) {
  return itemsize == 4 && nv == 4 && rt == 0 && ft == 0 && fy == fx &&
         (fy == 1 || fy == 2) && ry >= 1 && ry <= kPairRMax &&
         rx + fx <= kFxMax;
}

template <typename T>
int launch(const void* in, void* out, int ny, int nx, int nt, int nv, int ry,
           int rx, int rt, int fy, int fx, int ft, int ty, int tx, int tt,
           double sigma, double h, double n_eff, void* stream) {
  if ((long long)ny * nx * nt == 0 || nv == 0) return 0;
  const bool pairs = pair_build(nv, sizeof(T), ry, rx, rt, fy, fx, ft);
  // the patch reaches along t: runs of 4 y at 2 t, else of 8 y at one t
  const bool deep = ft > 0;
  const int R = deep ? 4 : 8, C = deep ? 2 : 1;
  const int lx = pairs ? rx + fx : fx;   // lanes before the first output
  if (ry < 0 || rx < 0 || rt < 0 || fy < 0 || fx < 0 || ft < 0 ||
      fy > kFMax || ft > kFMax || fx > kFxMax || tx != 32 - 2 * lx ||
      ty < R || tt < C || ty % R || tt % C)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * (ty / R) * (tt / C);
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const long long recs = (long long)(ty + 2 * (ry + fy)) * (32 + 2 * rx) *
                         (tt + 2 * (rt + ft));
  const long long smem = recs * nv * (long long)sizeof(T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
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
  p.aligned16 = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  const unsigned nb = (unsigned)blocks;
  // the builds with every radius fixed, each with and without n_eff
  const bool ne = p.use_neff;
  if constexpr (sizeof(T) == 4) {
    if (pairs && fy == 1)
      return launch_with<T>(ne ? nlmeans_ring_pairs<1, 1, 8, 1>
                               : nlmeans_ring_pairs<1, 1, 8, 0>,
                            nb, threads, sm, s, src, dst, p);
    if (pairs)
      return launch_with<T>(ne ? nlmeans_ring_pairs<2, 2, 8, 1>
                               : nlmeans_ring_pairs<2, 2, 8, 0>,
                            nb, threads, sm, s, src, dst, p);
    if (nv == 4 && ft == 1 && fy == 1 && fx == 1)
      return launch_with<T>(ne ? nlmeans_ring<T, 4, 1, 1, 1, 4, 2, 1>
                               : nlmeans_ring<T, 4, 1, 1, 1, 4, 2, 0>,
                            nb, threads, sm, s, src, dst, p);
  }
  if (deep)
    return launch_with<T>(nlmeans_ring<T, 0, -1, -1, -1, 4, 2, -1>, nb,
                          threads, sm, s, src, dst, p);
  return launch_with<T>(nlmeans_ring<T, 0, -1, -1, 0, 8, 1, -1>, nb, threads,
                        sm, s, src, dst, p);
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
