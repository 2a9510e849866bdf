// Streaming probe: out = x + 1 over a contiguous (m, 1024) float32 tensor,
// row slabs staged through shared memory with a cp.async double buffer.
//
// Replaces: bench.py _measure_dma_through, the TPU's "DMA-through"
// ceiling: 512-row slabs copied by double-buffered manual DMA into VMEM
// scratch, one vector add, stored. It measures what a streaming kernel
// that stages its data faces, as opposed to a fused elementwise pass.
//
// Bound on the H100: bytes. Each element is read once and written once
// (8 bytes per float); there is one add per element. Design: a block of
// 256 threads walks slabs of kRows rows (32 KB) in a grid stride; while
// it adds 1 to slab s in shared memory and stores it with 16-byte stores,
// cp.async brings slab s + gridDim.x into the other buffer (64 KB of
// dynamic shared memory per block, three blocks per SM). Every thread
// stages and later reads the same 16-byte chunks of a slab, so its own
// cp.async.wait_group is the only synchronisation the buffers need.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 1024;
constexpr int kRows = 8;
constexpr int kThreads = 256;
constexpr int kChunks = kRows * kCols / 4;  // float4 chunks in a slab

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void stage(float4* buf, const float4* in,
                                      long long slab, long long total) {
  const long long first = slab * kChunks;
  for (int i = threadIdx.x; i < kChunks; i += kThreads)
    if (first + i < total) cp_async16(buf + i, in + first + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
    stream_probe_kernel(const float4* __restrict__ in,
                        float4* __restrict__ out, long long m) {
  extern __shared__ float4 smem[];
  const long long total = m * (kCols / 4);
  const long long slabs = (m + kRows - 1) / kRows;
  long long s = blockIdx.x;
  if (s < slabs) stage(smem, in, s, total);
  for (int b = 0; s < slabs; s += gridDim.x, b ^= 1) {
    const long long next = s + gridDim.x;
    if (next < slabs) {
      stage(smem + (b ^ 1) * kChunks, in, next, total);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    const float4* cur = smem + b * kChunks;
    const long long first = s * kChunks;
    for (int i = threadIdx.x; i < kChunks; i += kThreads) {
      if (first + i >= total) break;
      float4 v = cur[i];
      v.x = v.x + 1.0f;
      v.y = v.y + 1.0f;
      v.z = v.z + 1.0f;
      v.w = v.w + 1.0f;
      out[first + i] = v;
    }
  }
}

constexpr int kSmem = 2 * kChunks * (int)sizeof(float4);  // 64 KB

}  // namespace

extern "C" {

int nd_stream_probe_cols() { return kCols; }

int nd_stream_plus_one_f32(const void* in, void* out, long long m,
                           void* stream) {
  if (m == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stream_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_probe_kernel,
                                                kThreads, kSmem);
  const long long slabs = (m + kRows - 1) / kRows;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > slabs) blocks = slabs;
  stream_probe_kernel<<<(unsigned)blocks, kThreads, kSmem,
                        (cudaStream_t)stream>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), m);
  return (int)cudaGetLastError();
}

}  // extern "C"
