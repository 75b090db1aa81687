// Kernel C: the standalone quadrature FM discriminator with the polynomial
// atan2,  out[k] = gain * fast_atan2(Im, Re) of conj(x[k]) * x[k+1],
// k < n - 1, over a complex64 stream.
//
// Replaces _quad_kernel of rustradio_tpu/ops/pallas_kernels.py:91
// (reached through pallas_quad_demod, :112).  The TPU kernel built the
// previous sample from lane/sublane rotations of a (tile_rows, 128) tile
// and repaired each tile's first output outside the kernel (:94-109,
// :156-166).  Here each thread reads x[k] and x[k+1] itself (8-byte float2
// loads; the second read of each sample hits L1/L2), so there are no tiles
// and no seams.
//
// What bounds it on an H100: device memory.  8 B in and 4 B out per sample
// against ~25 flops; the grid-stride loop keeps neighbouring threads on
// neighbouring samples, so every load and store is coalesced.
//
// Numerics: the conjugate product rounds each product and each sum
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), as the plain
// PyTorch version does, so Re, Im and the sign that picks the +-pi branch
// match it bit for bit; the polynomial (rr::fast_atan2f) is shared with
// kernel B.

#include <cuda_runtime.h>

#include "fast_atan2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // 32 blocks of 256 per SM

__global__ void quad_demod_kernel(const float2* __restrict__ x, long long m,
                                  float gain, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < m;
       k += stride) {
    const float2 p = x[k];
    const float2 c = x[k + 1];
    const float dr = __fadd_rn(__fmul_rn(p.x, c.x), __fmul_rn(p.y, c.y));
    const float di = __fsub_rn(__fmul_rn(p.x, c.y), __fmul_rn(p.y, c.x));
    out[k] = gain * rr::fast_atan2f(di, dr);
  }
}

}  // namespace

// x: n complex64 samples (float2, 8-byte aligned); out: n - 1 f32.
// Returns the cudaError_t of the launch (0 on success); n < 2 launches
// nothing.
extern "C" int rr_quad_demod(const void* x, long long n, float gain, void* out,
                             void* stream) {
  if (n < 2) return 0;
  const long long m = n - 1;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quad_demod_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, m, gain, (float*)out);
  return (int)cudaGetLastError();
}
