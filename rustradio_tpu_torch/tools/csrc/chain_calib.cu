// Calibration of the card's latency between dependent operations, for the
// chain bounds of kernels D and E (sync_core.cuh) and F (cma.cu, whose sum
// over the taps is a butterfly of warp shuffles): one lane runs `iters`
// operations, each needing the result of the one before, between two reads
// of the SM's cycle counter.  cycles / iters is what one link of such a
// chain costs a lone lane; cycles over the launch's device time is the SM
// clock under this load.  Built and used by tools/time_sync.py (and through
// it by chip_smoke.py), by no path.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 16;

// kind 0: v = v + b            (__fadd_rn)
// kind 1: v = v / b            (__fdiv_rn)
// kind 2: v = v + b; if (v > c) v = v - c   (add, compare, conditional
//         subtract: the shape of kernel E's per-sample step)
// kind 3: v = v + b, one addition per turn of a loop that is not unrolled
//         (an addition and a taken branch)
// kind 4: v = shfl_xor(v, 1) + b, the whole warp (a link of kernel F's
//         butterfly: a shuffle and the addition that waits for it)
__global__ void chain_kernel(int kind, int iters, float a, float b, float c,
                             float* out, long long* cycles) {
  if (kind != 4 && threadIdx.x != 0) return;
  // kind 4: a value that differs from lane to lane, so that no shuffle
  // can be proven to return the lane's own value
  float v = kind == 4 ? a + (float)threadIdx.x : a;
  const long long t0 = clock64();
  if (kind == 0) {
#pragma unroll 1
    for (int i = 0; i < iters; i += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v = __fadd_rn(v, b);
    }
  } else if (kind == 1) {
#pragma unroll 1
    for (int i = 0; i < iters; i += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v = __fdiv_rn(v, b);
    }
  } else if (kind == 2) {
#pragma unroll 1
    for (int i = 0; i < iters; i += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        v = __fadd_rn(v, b);
        if (v > c) v = __fsub_rn(v, c);
      }
    }
  } else if (kind == 3) {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) v = __fadd_rn(v, b);
  } else {
#pragma unroll 1
    for (int i = 0; i < iters; i += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        v = __fadd_rn(__shfl_xor_sync(0xffffffffu, v, 1), b);
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x != 0) return;
  *out = v;
  *cycles = t1 - t0;
}

}  // namespace

// out: one f32 (the chain's result, so that nothing is optimised away);
// cycles: one int64.  iters is rounded up to a multiple of 16 (kinds 0-2,
// 4).
// Returns the cudaError_t of the launch.
extern "C" int rr_chain_calib(int kind, int iters, float a, float b, float c,
                              void* out, void* cycles, void* stream) {
  if (kind < 0 || kind > 4 || iters <= 0) return (int)cudaErrorInvalidValue;
  chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(kind, iters, a, b, c,
                                                  (float*)out,
                                                  (long long*)cycles);
  return (int)cudaGetLastError();
}
