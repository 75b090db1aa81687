// Kernel A: decimating real FIR, y[m] = sum_j taps[j] * x[m*deci - j],
// zero history, ceil(n/deci) outputs, true f32, over `rows` planes of n
// samples with the same taps (grid.y is the plane), so the I and Q planes
// of a complex stream are one launch.
//
// Replaces the TPU kernel rustradio_tpu/ops/pallas_kernels.py:202
// (_fir_band_kernel, reached through pallas_fir_decimate at :235).  The
// TPU form turns the FIR into a banded 128x128 matmul on the MXU; here it
// is the register-blocked dot product of fir_core.cuh on the CUDA cores.
//
// What bounds it on an H100 (3.35 TB/s, 33.5 T f32 FMA/s):
//   * 49 taps at deci 4 (the FM channel filter) is bound by device memory:
//     4 B in and 1 B out per input sample against 12 FMA, 6.3 us for 2^22
//     samples;
//   * 1205 taps at deci 1 is bound by f32 FMA throughput: 1205 FMA per
//     sample against 8 B moved, 0.151 ms for 2^22 samples.
// What the design does about it is the core's: R outputs per thread from
// a register window (shared loads per FMA fall from 2 to about 1.25/R, so
// the FMA pipe, not shared-memory issue, limits the long filter), padded
// phase rows without bank conflicts, 16-byte global loads with the ends
// of the plane masked, tiles aligned to the tile size, results written as
// float4.  Measured at 49% of the memory bound (49 taps, deci 4) and 63%
// of the FMA bound (1205 taps) on an H100 at 700 W.  fmaf in a fixed tap
// order; no TF32, no tensor cores (the reckoning of a tensor-core form is
// in fir_core.cuh).

#include <cuda_runtime.h>

#include "fir_core.cuh"

namespace {

using namespace rr::fir;

// Dynamic shared memory: [taps, phase-major | phase rows of the span].
template <int R, int D>
__global__ void __launch_bounds__(256, 3)
fir_decimate_kernel(const float* __restrict__ x, long long n,
                    const float* __restrict__ trev, Tile g, float* __restrict__ y,
                    long long m) {
  extern __shared__ __align__(16) float smem[];
  float* hp = smem;
  float* span = smem + g.nphase * g.tstride;
  const float* plane = x + (long long)blockIdx.y * n;
  float* out = y + (long long)blockIdx.y * m;
  const long long m0 = (long long)blockIdx.x * g.tile;

  stage_taps<D>(hp, trev, g, threadIdx.x, blockDim.x);
  const float* const planes[1] = {plane};
  stage_span<float, R, D, 1>(span, 0, g, planes, n, m0 * g.deci - (g.ntaps - 1), 0.0f,
                             threadIdx.x, blockDim.x);
  __syncthreads();

  const int t = threadIdx.x;
  const long long mt = m0 + (long long)t * R;
  if (t * R >= g.tile || mt >= m) return;
  float acc[1][R];
  accumulate<R, 1, 0>(span, 0, g, hp, t, acc);
  store_run<R>(out + mt, acc[0], m - mt);
}

template <int R, int D>
int launch(const float* x, int rows, long long n, const float* trev, int ntaps,
           int deci, float* y, long long m, const Shape& s, size_t smem,
           cudaStream_t stream) {
  static size_t allowed = 0;
  cudaError_t e = allow_smem(fir_decimate_kernel<R, D>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const Tile g = make_tile<R>(s.tile, 0, ntaps, deci);
  const dim3 grid((unsigned)((m + s.tile - 1) / s.tile), (unsigned)rows);
  fir_decimate_kernel<R, D><<<grid, s.threads, smem, stream>>>(x, n, trev, g, y, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows planes of n f32, contiguous; trev: ntaps f32 (taps reversed);
// y: rows planes of m = ceil(n/deci) f32.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int rr_fir_decimate(const void* x, int rows, long long n, const void* trev,
                               int ntaps, int deci, void* y, long long m,
                               void* stream) {
  if (ntaps < 1 || deci < 1 || n < 0 || m < 0 || rows < 0 || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || rows == 0) return 0;
  Shape s;
  size_t smem;
  if (!pick_shape(ntaps, deci, m * rows, 1, 0, 0, 0, &s, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* fn = launch<4, 0>;
  if (s.r == 8) {
    switch (fixed_deci(s, ntaps, deci)) {
      case 1: fn = launch<8, 1>; break;
      case 2: fn = launch<8, 2>; break;
      case 4: fn = launch<8, 4>; break;
      default: fn = launch<8, 0>;
    }
  }
  return fn((const float*)x, rows, n, (const float*)trev, ntaps, deci, (float*)y, m, s,
            smem, (cudaStream_t)stream);
}

extern "C" const char* rr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
