// Streaming probe: out = x + 1 over a contiguous (m, 1024) float32 tensor,
// row slabs staged through shared memory by the Tensor Memory Accelerator.
//
// Replaces: bench.py _measure_dma_through, the TPU's "DMA-through"
// ceiling: 512-row slabs copied by double-buffered manual DMA into VMEM
// scratch, one vector add, stored. It measures what a streaming kernel
// that stages its data faces, as opposed to a fused elementwise pass.
//
// Bound on the H100: bytes. Each element is read once and written once
// (8 bytes per float); there is one add per element. Design: one or two
// persistent blocks per SM (the wrapper's grid, from an occupancy query
// it makes once per device); block b walks slabs b, b + grid, ... of
// kRows rows (32 KB), so block counts differ by at most one slab. A ring
// of kStages slab buffers in shared memory: thread 0 issues a bulk copy
// (cp.async.bulk, TMA) of each slab into its buffer, completed on that
// buffer's mbarrier; every thread waits there, adds 1 to its float4s in
// shared memory and fences its writes for the async proxy; after a
// barrier thread 0 writes the slab out with a bulk store
// (cp.async.bulk.global.shared::cta) and refills the previous slab's
// buffer once that slab's store has read shared memory
// (cp.async.bulk.wait_group.read 1). So kStages - 1 loads and up to two
// stores are in flight per block, and no thread spends registers or
// instructions on the copies.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 1024;
constexpr int kRows = 8;
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kSlab4 = kRows * kCols / 4;              // float4s in a slab
constexpr int kSlabBytes = kSlab4 * 16;                // 32 KB
constexpr int kSmem = kStages * kSlabBytes + kStages * 8;   // + mbarriers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Slab s (rows s*kRows ..) of `in` into the buffer at `dst`, completing
// `bytes` on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0u;
}

__global__ void __launch_bounds__(kThreads)
    stream_probe_kernel(const float* __restrict__ in, float* __restrict__ out,
                        long long m) {
  extern __shared__ __align__(128) float4 smem[];
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + kStages * kSlab4);
  const long long slabs = (m + kRows - 1) / kRows;
  const long long first = blockIdx.x;
  const long long count =
      first < slabs ? (slabs - 1 - first) / gridDim.x + 1 : 0;
  const long long step = (long long)gridDim.x * kRows * kCols;   // floats
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + st))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto rows_of = [&](long long i) {    // rows of the block's i-th slab
    const long long r = m - (first + i * gridDim.x) * kRows;
    return (unsigned)(r < kRows ? r : kRows);
  };
  const float* src = in + first * kRows * kCols;
  float* dst = out + first * kRows * kCols;
  if (threadIdx.x == 0)
    for (int st = 0; st < kStages && st < count; ++st)
      bulk_load(smem_addr(smem + st * kSlab4), src + st * step,
                rows_of(st) * kCols * 4, smem_addr(bars + st));
  for (long long i = 0; i < count; ++i) {
    const int st = (int)(i % kStages);
    const unsigned n4 = rows_of(i) * (kCols / 4);
    while (!mbar_try_wait(smem_addr(bars + st), (unsigned)(i / kStages) & 1u)) {
    }
    float4* buf = smem + st * kSlab4;
    for (unsigned c = threadIdx.x; c < n4; c += kThreads) {
      float4 v = buf[c];
      v.x = v.x + 1.0f;
      v.y = v.y + 1.0f;
      v.z = v.z + 1.0f;
      v.w = v.w + 1.0f;
      buf[c] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              dst + i * step),
          "r"(smem_addr(buf)), "r"(n4 * 16)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      const long long next = i - 1 + kStages;   // into slab i-1's buffer
      if (i >= 1 && next < count) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int pst = (int)((i - 1) % kStages);
        bulk_load(smem_addr(smem + pst * kSlab4), src + next * step,
                  rows_of(next) * kCols * 4, smem_addr(bars + pst));
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

int nd_stream_probe_cols() { return kCols; }

// The launch configuration, queried once per device by the wrapper: lets
// the kernel use its shared memory and returns its persistent blocks per
// SM (one or two) in *per_sm.
int nd_stream_probe_setup(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stream_probe_kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  *per_sm = n < 2 ? n : 2;
  return 0;
}

int nd_stream_plus_one_f32(const void* in, void* out, long long m,
                           int blocks, void* stream) {
  if (m == 0) return 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const long long slabs = (m + kRows - 1) / kRows;
  if (blocks > slabs) blocks = (int)slabs;
  stream_probe_kernel<<<(unsigned)blocks, kThreads, kSmem,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), m);
  return (int)cudaGetLastError();
}

}  // extern "C"
