// The polynomial atan2 of the port's discriminators (kernels B and C), in
// one place: the octant reduction and 7th-order odd polynomial of
// ops/demod.fast_atan2 and rustradio_tpu/ops/pallas_kernels.py:63-88
// (|err| < 1e-4 rad).  The division is IEEE (never build with
// --use_fast_math), so z matches the plain version's.
#pragma once

#include <cuda_runtime.h>

namespace rr {

__device__ __forceinline__ float fast_atan2f(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float z = mn / fmaxf(mx, 1e-37f);
  const float z2 = z * z;
  float a = z * (0.9998660f +
                 z2 * (-0.3302995f +
                       z2 * (0.1801410f + z2 * (-0.0851330f + z2 * 0.0208351f))));
  if (ay > ax) a = 1.57079637f - a;   // float32(pi / 2)
  if (x < 0.0f) a = 3.14159274f - a;  // float32(pi)
  return y < 0.0f ? -a : a;
}

}  // namespace rr
