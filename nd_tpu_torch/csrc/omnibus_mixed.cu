// Complex-Wishart omnibus change-point scan at the scan's own precision,
// one thread per series: the decisions of ops.change.change_detection
// ('mixed', 'float64' or 'float32' statistics) for a batch of series.
//
// Replaces: the XLA program of nd_tpu/ops/change.py change_detection
// (stat_dtype='mixed'), which the reference's exact mode runs on its
// compacted suspect pixels and, where no kernel serves the series length,
// on the whole grid. Input is a contiguous (nrows, k, 4) series of
// [C11, C12.re, C12.im, C22] in the sum type S; the output is the flag
// planes (bit t%31 of int32 plane t//31, planes of nrows), the layout of
// ops.change.pack_flags.
//
// Bound on the H100: neither bytes nor operations but the serial chain of
// one series. A series costs sum over its restart rounds of (k - l) steps,
// each a few dependent float64 operations and two float64 logs; the
// suspects of the exact mode are thousands of series, so the card runs a
// few warps per SM and the longest chain (a pixel with many change points)
// sets the time. The plain PyTorch version launches about 40 operations
// per time step per round and syncs the host once per round; here a thread
// runs its own rounds in registers and stops when its series is done, as
// csrc/omnibus.cu does in float32. Layout: the gathered (nrows, k, 4)
// rows are read as they come from index_select, 16 bytes (float) or 32
// bytes (double) per step; a thread walks its own cache lines, which stay
// in L1 / L2 between steps and rounds (path B's 27 MB of suspects fit the
// 50 MB L2), so a transposed (k, 4, nrows) copy would buy coalescing the
// chain does not need, for one more pass over the rows.
//
// Numerics: decisions bit-equal to the plain version on the card, so every
// expression follows ops/change.py change_detection_plain operation by
// operation: the per-step determinant in S, |det| converted to L and
// logged; channel sums in S from the anchor l, strictly left to right
// (a sum started at +0 at t = l equals the plain version's masked +0
// additions); the window determinant in L from the sums converted; the
// folded statistic n log_prod - (n j) ln det_sum against the host table
// C(j), or the unfolded z = -2 rho logQ against thr(j) exactly as PyTorch
// evaluates that expression on the card: a Python scalar over a tensor is
// reciprocal() * scalar (Tensor.__rdiv__) and a CUDA tensor over a CPU
// scalar is a product with the scalar's reciprocal (inv_nf below). log and
// logf are CUDA's math-library functions, which PyTorch's CUDA log calls;
// built with -fmad=false and without fast math, so nothing is contracted.
// An odd count of negative determinants makes log_prod NaN, and a NaN
// statistic never hits.

#include <cuda_runtime.h>
#include <cmath>

namespace {

__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }

__device__ __forceinline__ void load4(const float* p, float& a, float& b,
                                      float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x;
  b = v.y;
  c = v.z;
  d = v.w;
}
__device__ __forceinline__ void load4(const double* p, double& a, double& b,
                                      double& c, double& d) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  a = v0.x;
  b = v0.y;
  c = v1.x;
  d = v1.y;
}

// S: sum type (the channels and their running sums); L: log type (the
// determinant of the sums, logs, statistic and decision).
template <typename S, typename L>
__global__ void omnibus_mixed_kernel(const S* __restrict__ rows,
                                     int* __restrict__ planes,
                                     long long nrows, int k,
                                     const L* __restrict__ tab, int folded,
                                     L nf, L inv_nf) {
  const int nplanes = (k + 30) / 31;
  const L kNaN = (L)NAN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < nrows; r += stride) {
    const S* ser = rows + r * (long long)k * 4;
    for (int pp = 0; pp < nplanes; ++pp) planes[pp * nrows + r] = 0;
    int l = 0;
    bool active = k > 1;
    for (int round = 0; round < k - 1 && active; ++round) {
      S s11 = 0, s12r = 0, s12i = 0, s22 = 0;
      L sld = 0;
      int neg = 0;
      int t_first = k;
      bool hit_last = false;
      for (int t = l; t < k; ++t) {
        S c11, c12r, c12i, c22;
        load4(ser + 4 * t, c11, c12r, c12i, c22);
        const S det = c11 * c22 - c12r * c12r - c12i * c12i;
        s11 = s11 + c11;
        s12r = s12r + c12r;
        s12i = s12i + c12i;
        s22 = s22 + c22;
        neg += det < (S)0 ? 1 : 0;
        sld = sld + lg((L)absval(det));
        if (t < l + 1) continue;
        const L jt = (L)(t - l + 1);
        const L a11 = (L)s11, a12r = (L)s12r, a12i = (L)s12i, a22 = (L)s22;
        const L dos = a11 * a22 - a12r * a12r - a12i * a12i;
        const L log_prod = (neg & 1) ? kNaN : sld;
        bool hit;
        if (folded) {
          const L stat = nf * log_prod - (nf * jt) * lg(dos);
          hit = stat < tab[t - l + 1];
        } else {
          // logq = nf * (P jt ln jt + log_prod - jt ln det_sum)
          const L logq =
              nf * ((L)2 * jt * lg(jt) + log_prod - jt * lg(dos));
          // rho = 1 - (2P^2-1)/(6 (jt-1) P) * (jt/nf - 1/(nf jt))
          const L r7 = (L)1 / ((L)6 * (jt - (L)1) * (L)2) * (L)7;
          const L rho = (L)1 - r7 * (jt * inv_nf - (L)1 / (nf * jt) * (L)1);
          const L z = (L)-2 * rho * logq;
          hit = z > tab[t - l + 1];
        }
        if (hit && t_first == k) t_first = t;
        if (t == k - 1) hit_last = hit;
      }
      // the global test over [l, k-1] is the t = k-1 window
      active = hit_last;
      if (!active) break;
      int pos = t_first;  // hit_last guarantees a hit
      if (pos < l + 1) pos = l + 1;
      planes[(pos / 31) * nrows + r] |= 1 << (pos % 31);
      l = pos;
      active = l < k - 1;
    }
  }
}

template <typename S, typename L>
int launch(const void* rows, void* planes, long long nrows, int k,
           const void* table, int folded, double nf, void* stream) {
  // few threads a block: the exact mode's thousands of suspects still
  // spread over every SM
  const int threads = 64;
  long long blocks = (nrows + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  const L nfl = (L)nf;
  omnibus_mixed_kernel<S, L><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const S*>(rows), static_cast<int*>(planes), nrows, k,
      static_cast<const L*>(table), folded, nfl, (L)1 / nfl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sum_f64 / log_f64: the sum and log types (1 double, 0 float); 'mixed'
// on float32 rows is (0, 1). table: k+1 entries of the log type, on the
// device.
int nd_omnibus_mixed(const void* rows, void* planes, long long nrows, int k,
                     int sum_f64, int log_f64, const void* table, int folded,
                     double nf, void* stream) {
  if (k < 1 || (sum_f64 && !log_f64)) return (int)cudaErrorInvalidValue;
  if (nrows == 0) return 0;
  if (sum_f64)
    return launch<double, double>(rows, planes, nrows, k, table, folded, nf,
                                  stream);
  if (log_f64)
    return launch<float, double>(rows, planes, nrows, k, table, folded, nf,
                                 stream);
  return launch<float, float>(rows, planes, nrows, k, table, folded, nf,
                              stream);
}

}  // extern "C"
