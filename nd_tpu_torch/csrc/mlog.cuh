// Accurate float32 natural log shared by the omnibus kernels
// (omnibus.cu, omnibus_scan.cu).
//
// Port of nd_tpu/ops/change_pallas.py _mlog: x = m * 2^e with m centred
// in [sqrt(1/2), sqrt(2)), ln m = 2 atanh(t), t = (m-1)/(m+1), with a
// short odd polynomial (about 1 ulp). Non-normal inputs defer to logf.
// The omnibus margin bounds charge 1e-5 per evaluation of this function;
// built with -fmad=false, so every step rounds as in the plain PyTorch
// version (ops.change_cuda._mlog).

#pragma once

#include <cuda_runtime.h>
#include <cmath>

__device__ __forceinline__ float mlog(float x) {
  const int xi = __float_as_int(x);
  const int e = (int)((unsigned)xi >> 23) - 127;
  float m = __int_as_float((xi & 0x007fffff) | 0x3f800000);
  const bool big = m > 1.4142135f;
  m = big ? m * 0.5f : m;
  const float ef = (float)(e + (big ? 1 : 0));
  const float t = (m - 1.0f) / (m + 1.0f);
  const float t2 = t * t;
  float p = (float)(1.0 / 9.0);
  p = p * t2 + (float)(1.0 / 7.0);
  p = p * t2 + (float)(1.0 / 5.0);
  p = p * t2 + (float)(1.0 / 3.0);
  p = p * t2 + 1.0f;
  const float res = ef * 0.693359375f
                    + (2.0f * t * p + ef * (float)(-2.121944400546905e-04));
  const bool normal = x >= 1.17549435e-38f && x < INFINITY;
  return normal ? res : logf(x);
}
