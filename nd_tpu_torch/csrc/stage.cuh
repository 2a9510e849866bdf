// Staging a block's input through shared memory. The omnibus kernels that
// own P consecutive pixels per block (omnibus_scan.cu, omnibus.cu) copy
// T-step chunks with coalesced 16-byte cp.async copies into rows of an
// odd stride, so that a warp's float4 reads of one step across 32 pixels
// are free of bank conflicts; the stencil (stencil.cu) copies its halo box
// in 16-byte blocks placed at their source's alignment, and the positions
// the boundary mode maps one element at a time (cp_async_elem).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One 4- or 8-byte element, global -> shared, through L1 (cp.async.ca).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are pending; an n
// above 7 waits for more than it must, which is safe.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Chunk c (steps c*T .. c*T + L - 1) of the block's pv pixels into buf,
// pixel q's row at q * S float4s. Item i = q * L + s goes to thread
// i % blockDim.x, so a warp copies runs of L consecutive 16-byte steps,
// each run contiguous in the input. One commit group per call and thread,
// empty or not.
__device__ __forceinline__ void load_chunk(float4* buf,
                                           const float4* __restrict__ values,
                                           long long p0, int pv, int k,
                                           int T, int S, int c) {
  const int t0 = c * T;
  const int L = min(T, k - t0);
  const int n = blockDim.x;
  const int dq = n / L, ds = n - dq * L;
  int q = threadIdx.x / L;
  int s = threadIdx.x - q * L;
  for (int i = threadIdx.x; i < pv * L; i += n) {
    cp_async16(buf + q * S + s, values + (p0 + q) * k + t0 + s);
    q += dq;
    s += ds;
    if (s >= L) {
      s -= L;
      ++q;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
