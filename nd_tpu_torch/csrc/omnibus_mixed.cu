// Complex-Wishart omnibus change-point scan at the scan's own precision,
// one warp per series: the decisions of ops.change.change_detection
// ('mixed', 'float64' or 'float32' statistics) for the exact mode's
// suspects, selected on the card, or for every series of a batch.
//
// Replaces: the XLA program of nd_tpu/ops/change.py change_detection
// (stat_dtype='mixed'), which the reference's exact mode runs on its
// compacted suspect pixels and, where no kernel serves the series length,
// on the whole grid. Input is a contiguous (nrows, k, 4) series of
// [C11, C12.re, C12.im, C22] in the sum type S (the exact mode's cube
// itself); the output is written straight into the flag planes (bit t%31
// of int32 plane t//31, planes of nrows; the layout of
// ops.change.pack_flags and of the kernels' packed planes).
//
// Two kernels behind one entry point. select_kernel: each thread tests one
// pixel's margin, ~(margin > eps) with NaN included, a warp ballots its
// suspects and one atomic add per warp reserves their places in an index
// queue whose count stays in device memory. omnibus_mixed_kernel:
// persistent warps take the queue's series one at a time (or every row,
// with no margins), so the host neither waits for the count nor gathers
// and scatters.
//
// Bound on the H100: the chain of one series' running sums. A series
// costs, over its restart rounds, sum of (k - l) steps, each a float64
// log of the window determinant; run by one thread with both logs of a
// step on its chain, a series with many change points (the bursty
// column: 66 rounds at k = 200) sets the time. So a warp scans one
// series:
//  - the per-step terms that do not depend on the anchor l, the
//    determinant and its log, are computed by the lanes in parallel
//    once per series (the channels and the log into shared memory, the
//    sign as ballot words);
//  - a round's sums run strictly left to right on five lanes (the four
//    channels and the log; one addition per step, as the plain version
//    adds, never a tree or a cumsum), eight steps' loads at a time off
//    the chain of additions; the prefixes are stored, and lane i tests
//    the window [l, base + i] of each 32-step chunk (its determinant,
//    log, statistic and test), a ballot finding the first hit (__ffs);
//  - only a round's first hit and its global window [l, k-1] decide, and
//    the next round starts at that first hit, so rounds overlap: up to
//    kGroups rounds' sums advance together on their own five lanes
//    (scan_series says how), and a series with a change every few steps
//    walks its chunks about once per kGroups rounds;
//  - the parity of the negative determinants in [l, t] is a popcount of
//    the ballot words (an exact integer count, as the plain version's).
// The suspects of the exact mode are thousands of series over the whole
// card, so a warp per series keeps every SM busy.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // series (warps) a block works on at once
constexpr int kSmemMax = 232448;   // shared memory a block may use (H100)
// The most device memory the workspace of a long series' grid takes.
constexpr long long kWorkBytes = 64LL << 20;

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

// Bits 0 .. n-1 (n <= 32).
__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? kFull : (1u << n) - 1u;
}

constexpr int kPre = 33;    // row stride of the channel prefixes (banks)
constexpr int kGroups = 6;  // rounds in flight: five lanes each

// Shared-memory bytes of one warp: the per-step logs (k of L), the
// chunk's log prefixes (32 of L), the channels (4 rows of k of S), the
// channel prefixes (4 rows of kPre of S) and the sign words.
template <typename S, typename L>
__host__ __device__ inline long long warp_smem(int k) {
  const long long bytes = (long long)(k + 32) * sizeof(L) +
                          4LL * (k + kPre) * sizeof(S) +
                          4LL * ((k + 31) / 32);
  return (bytes + 15) / 16 * 16;
}

// The decision of window [l, t] (length jt) from its sums, as the plain
// version takes it.
template <typename L>
__device__ __forceinline__ bool window_hit(L a11, L a12r, L a12i, L a22,
                                          L sld, bool odd, L jt, L thr,
                                          int folded, L nf, L inv_nf) {
  const L dos = a11 * a22 - a12r * a12r - a12i * a12i;
  const L log_prod = odd ? (L)NAN : sld;
  if (folded) {
    const L stat = nf * log_prod - (nf * jt) * lg(dos);
    return stat < thr;
  }
  // logq = nf * (P jt ln jt + log_prod - jt ln det_sum)
  const L logq = nf * ((L)2 * jt * lg(jt) + log_prod - jt * lg(dos));
  // rho = 1 - (2P^2-1)/(6 (jt-1) P) * (jt/nf - 1/(nf jt))
  const L r7 = (L)1 / ((L)6 * (jt - (L)1) * (L)2) * (L)7;
  const L rho = (L)1 - r7 * (jt * inv_nf - (L)1 / (nf * jt) * (L)1);
  const L z = (L)-2 * rho * logq;
  return z > thr;
}

// The whole restart scan of series r by one warp; flags into planes.
//
// The rounds run as a pipeline of waves. A wave starts a round at its
// anchor a0 and walks the chunks from there to k-1 once. Each pending
// round owns a group of five lanes (its four channel sums and its log
// sum; lanes 0-29, kGroups groups). The newest round, the head, has its
// prefixes stored and its windows tested chunk by chunk; its first hit t
// is the next round's anchor, which takes the next free group at once
// (its sums start at t, within the same chunk) and becomes the head; with
// no group free, t waits for the next wave. The older rounds' groups only
// carry their sums to k-1. At the end of the walk every pending round's
// global window [a, k-1] is tested, and the rounds are committed in order
// while their global tests hit, as the sequential scan commits them.
template <typename S, typename L>
__device__ void scan_series(const S* __restrict__ rows,
                            int* __restrict__ planes, long long nrows,
                            long long r, int k, const L* __restrict__ tab,
                            int folded, L nf, L inv_nf, L* ld, L* pre_l,
                            S* xs, S* pre_s, unsigned* negw) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / 5, ch = lane - 5 * grp;   // lanes 30, 31: none
  const S* ser = rows + r * (long long)k * 4;
  // the terms that do not depend on the anchor, in parallel
  for (int base = 0; base < k; base += 32) {
    const int t = base + lane;
    bool neg = false;
    if (t < k) {
      S c11, c12r, c12i, c22;
      load4(ser + 4 * t, c11, c12r, c12i, c22);
      xs[t] = c11;
      xs[k + t] = c12r;
      xs[2 * k + t] = c12i;
      xs[3 * k + t] = c22;
      const S det = c11 * c22 - c12r * c12r - c12i * c12i;
      ld[t] = lg((L)absval(det));
      neg = det < (S)0;
    }
    const unsigned w = __ballot_sync(kFull, neg);
    if (lane == 0) negw[base >> 5] = w;
  }
  if (lane == 0)
    for (int pp = 0; pp < (k + 30) / 31; ++pp) planes[pp * nrows + r] = 0;
  __syncwarp();
  // the lane's sum: a channel (ch 0-3) or the logs (ch 4); both are
  // added, the other is unused
  const S* xrow = xs + (ch & 3) * k;
  S* ps = pre_s + (ch & 3) * kPre;
  int a0 = 0;
  while (a0 < k - 1) {                    // a wave
    int my_a = grp == 0 ? a0 : k;         // k: the group holds no round
    S sum = 0;
    L sld = 0;
    int my_odd = 0;                       // negative dets in [my_a, base-1]
    int m = 0, head_a = a0, next_a = -1;  // next_a: the head's first hit
    for (int base = a0 & ~31; base < k; base += 32) {
      const int j1 = k - base < 32 ? k - base : 32;
      const unsigned wb = negw[base >> 5];
      // add [max(my_a, base), base + j1) to the sums of the lanes in
      // groups from..to; the head's prefixes stored
      auto add = [&](int from, int to) {
        if (grp < from || grp > to) return;
        const int j0 = my_a > base ? my_a - base : 0;
        const bool store = grp == m;
        for (int g = j0 & ~7; g < j1; g += 8) {
          // eight steps' loads at once, off the chain of additions (in
          // bounds past k: the prefix rows follow the channels and the
          // log prefixes follow the logs)
          S xv[8];
          L yv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            xv[i] = xrow[base + g + i];
            yv[i] = ld[base + g + i];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j = g + i;
            if (j >= j0 && j < j1) {
              sum = sum + xv[i];
              sld = sld + yv[i];
              if (store) {
                if (ch < 4)
                  ps[j] = sum;
                else
                  pre_l[j] = sld;
              }
            }
          }
        }
      };
      add(0, m);
      // the head's windows in this chunk, and its successors'
      while (next_a < 0) {
        __syncwarp();
        const int hb = head_a > base ? head_a - base : 0;
        const int carry = __shfl_sync(kFull, my_odd, 5 * m);
        const int t = base + lane;
        bool hit = false;
        if (t >= head_a + 1 && t < k)
          hit = window_hit<L>(
              (L)pre_s[lane], (L)pre_s[kPre + lane],
              (L)pre_s[2 * kPre + lane], (L)pre_s[3 * kPre + lane],
              pre_l[lane],
              (carry + __popc(wb & ~low_bits(hb) & low_bits(lane + 1))) & 1,
              (L)(t - head_a + 1), tab[t - head_a + 1], folded, nf, inv_nf);
        const unsigned hits = __ballot_sync(kFull, hit);
        __syncwarp();   // the prefixes are rewritten below
        if (!hits) break;
        const int tf = base + __ffs(hits) - 1;
        if (m + 1 == kGroups || tf >= k - 1) {
          next_a = tf;    // the next wave's anchor (or the last step)
          break;
        }
        ++m;
        head_a = tf;
        if (grp == m) {
          my_a = tf;
          sum = 0;
          sld = 0;
          my_odd = 0;
        }
        add(m, m);
      }
      if (my_a < k) {
        const int j0 = my_a > base ? my_a - base : 0;
        my_odd += __popc(wb & ~low_bits(j0) & low_bits(j1));
      }
    }
    // every pending round's global window [a, k-1], one lane a group
    const int src = 5 * (grp < kGroups ? grp : 0);
    const L a11 = (L)__shfl_sync(kFull, sum, src);
    const L a12r = (L)__shfl_sync(kFull, sum, src + 1);
    const L a12i = (L)__shfl_sync(kFull, sum, src + 2);
    const L a22 = (L)__shfl_sync(kFull, sum, src + 3);
    const L lsum = __shfl_sync(kFull, sld, src + 4);
    bool glob = false;
    if (ch == 0 && grp <= m && my_a < k - 1)
      glob = window_hit<L>(a11, a12r, a12i, a22, lsum, my_odd & 1,
                           (L)(k - my_a), tab[k - my_a], folded, nf, inv_nf);
    const unsigned gmask = __ballot_sync(kFull, glob);
    // commit the rounds in order while their global tests hit; a wave
    // whose rounds all commit hands the head's first hit to the next
    bool more = true;
    for (int g = 0; g <= m && more; ++g) {
      const int next = __shfl_sync(kFull, my_a, 5 * (g + 1 < kGroups ? g + 1
                                                                    : 0));
      const int pos = g < m ? next : next_a;   // the round's first hit
      more = ((gmask >> (5 * g)) & 1u) && pos >= 0;
      if (!more) break;
      if (lane == 0) planes[(pos / 31) * nrows + r] |= 1 << (pos % 31);
      a0 = pos;
    }
    if (!more) break;
  }
  __syncwarp();   // the logs and sign words are rewritten by the next series
}

// Persistent warps over the series: queue[i] for i < *count (the exact
// mode's suspects), or every row i < nrows when queue is null. Each warp
// keeps its series' channels, logs and prefixes in shared memory or, for
// series too long for it (G), in its own slice of the device workspace
// work (the same layout; the warp's reads and writes then go through L1
// and L2).
template <typename S, typename L, bool G>
__global__ void __launch_bounds__(32 * kWarps)
    omnibus_mixed_kernel(const S* __restrict__ rows,
                         const int* __restrict__ queue,
                         const int* __restrict__ count,
                         int* __restrict__ planes, long long nrows, int k,
                         const L* __restrict__ tab, int folded, L nf,
                         L inv_nf, unsigned char* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  unsigned char* mine =
      G ? work + ((long long)blockIdx.x * kWarps + warp) * warp_smem<S, L>(k)
        : smem + warp * warp_smem<S, L>(k);
  L* ld = reinterpret_cast<L*>(mine);
  L* pre_l = ld + k;
  S* xs = reinterpret_cast<S*>(pre_l + 32);
  S* pre_s = xs + 4 * k;
  unsigned* negw = reinterpret_cast<unsigned*>(pre_s + 4 * kPre);
  const long long n = queue ? (long long)*count : nrows;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long i = (long long)blockIdx.x * kWarps + warp; i < n; i += step)
    scan_series<S, L>(rows, planes, nrows, queue ? (long long)queue[i] : i, k,
                      tab, folded, nf, inv_nf, ld, pre_l, xs, pre_s, negw);
}

__global__ void select_kernel(const float* __restrict__ margin, float eps,
                              long long npix, int* __restrict__ queue,
                              int* __restrict__ count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool suspect = i < npix && !(margin[i] > eps);   // NaN included
  const unsigned mask = __ballot_sync(kFull, suspect);
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  if (suspect) queue[base + __popc(mask & low_bits(lane))] = (int)i;
}

// The persistent grid of the scan kernel for k steps: as many blocks as
// the card holds at once. The dynamic shared-memory limit is raised to
// the most a block may use (the attribute belongs to the kernel, not to
// k: a lower limit set for a short series would refuse a longer one).
// Series too long for the shared memory take the workspace kernel, on
// as many blocks as keep its workspace within kWorkBytes (at least one
// a multiprocessor).
template <typename S, typename L>
long long grid(int k) {
  const long long block = kWarps * warp_smem<S, L>(k);
  const bool g = block > kSmemMax;
  int dev = 0, sms = 0, per_sm = 0;
  if ((!g && cudaFuncSetAttribute(omnibus_mixed_kernel<S, L, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemMax)) ||
      cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      (g ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, omnibus_mixed_kernel<S, L, true>, 32 * kWarps, 0)
         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, omnibus_mixed_kernel<S, L, false>, 32 * kWarps,
               (size_t)block)))
    return -1;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g && blocks * block > kWorkBytes)
    blocks = kWorkBytes / block > sms ? kWorkBytes / block : sms;
  return blocks;
}

template <typename S, typename L>
int launch(const void* rows, const int* queue, const int* count,
           void* planes, long long nrows, int k, const void* table,
           int folded, double nf, long long blocks, void* work,
           void* stream) {
  const long long block = kWarps * warp_smem<S, L>(k);
  const long long need = (nrows + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need;
  const L nfl = (L)nf;
  const S* r = static_cast<const S*>(rows);
  int* p = static_cast<int*>(planes);
  const L* t = static_cast<const L*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  if (work)
    omnibus_mixed_kernel<S, L, true><<<(unsigned)blocks, 32 * kWarps, 0, s>>>(
        r, queue, count, p, nrows, k, t, folded, nfl, (L)1 / nfl,
        static_cast<unsigned char*>(work));
  else
    omnibus_mixed_kernel<S, L, false>
        <<<(unsigned)blocks, 32 * kWarps, (size_t)block, s>>>(
            r, queue, count, p, nrows, k, t, folded, nfl, (L)1 / nfl,
            nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of a block (kWarps series) for k steps; past the
// card's limit the wrapper gives the kernel this many bytes of device
// workspace a block instead.
long long nd_omnibus_mixed_smem(int k, int sum_f64, int log_f64) {
  if (sum_f64) return kWarps * warp_smem<double, double>(k);
  if (log_f64) return kWarps * warp_smem<float, double>(k);
  return kWarps * warp_smem<float, float>(k);
}

// The scan kernel's persistent grid on the current device for k steps
// (blocks; -1 on an error), its shared-memory limit raised: the wrapper
// asks once per (k, types, device).
long long nd_omnibus_mixed_grid(int k, int sum_f64, int log_f64) {
  if (sum_f64) return grid<double, double>(k);
  if (log_f64) return grid<float, double>(k);
  return grid<float, float>(k);
}

// sum_f64 / log_f64: the sum and log types (1 double, 0 float); 'mixed'
// on float32 rows is (0, 1). table: k+1 entries of the log type, on the
// device. blocks: nd_omnibus_mixed_grid's. With margin null, every row
// is scanned; otherwise the rows whose margin is not above eps (NaN
// included) are selected first, into queue (nrows ints) and their number
// into *count, both on the device. work: null where a block's series fit
// the shared memory, else blocks times nd_omnibus_mixed_smem's bytes of
// device memory.
int nd_omnibus_mixed(const void* rows, const void* margin, float eps,
                     void* queue, void* count, void* planes, long long nrows,
                     int k, int sum_f64, int log_f64, const void* table,
                     int folded, double nf, long long blocks, void* work,
                     void* stream) {
  const long long block = nd_omnibus_mixed_smem(k, sum_f64, log_f64);
  if (k < 1 || (sum_f64 && !log_f64) || (margin && (!queue || !count)) ||
      blocks < 1 || nrows >= (1LL << 31) || (block > kSmemMax) != !!work)
    return (int)cudaErrorInvalidValue;
  int* q = margin ? static_cast<int*>(queue) : nullptr;
  int* c = margin ? static_cast<int*>(count) : nullptr;
  if (margin) {
    const int err = (int)cudaMemsetAsync(c, 0, sizeof(int),
                                         (cudaStream_t)stream);
    if (err) return err;
  }
  if (nrows == 0) return 0;
  if (margin) {
    const int threads = 256;
    select_kernel<<<(unsigned)((nrows + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(static_cast<const float*>(margin),
                                            eps, nrows, q, c);
  }
  if (sum_f64)
    return launch<double, double>(rows, q, c, planes, nrows, k, table,
                                  folded, nf, blocks, work, stream);
  if (log_f64)
    return launch<float, double>(rows, q, c, planes, nrows, k, table, folded,
                                 nf, blocks, work, stream);
  return launch<float, float>(rows, q, c, planes, nrows, k, table, folded,
                              nf, blocks, work, stream);
}

}  // extern "C"
