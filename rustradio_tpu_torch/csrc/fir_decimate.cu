// Kernel A: decimating real FIR, y[m] = sum_j taps[j] * x[m*deci - j],
// zero history, ceil(n/deci) outputs, true f32.
//
// Replaces the TPU kernel rustradio_tpu/ops/pallas_kernels.py:202
// (_fir_band_kernel, reached through pallas_fir_decimate at :235).  The
// TPU form turns the FIR into a banded 128x128 matmul on the MXU; here it
// is a strided dot product with a halo, one output per thread.
//
// What bounds it on an H100:
//   * 49 taps at deci 4 (the FM channel filter) is memory-bound: about
//     5 B of device memory per input sample (4 B in, 1 B out) against
//     about 12 FMA per input sample.
//   * 1205 taps at deci 1 is bound by f32 FMA throughput on the CUDA
//     cores (1205 FMA per sample against 8 B moved).
// What the design does about it:
//   * the taps live in shared memory (at most 4096 f32 = 16 KB) and every
//     warp reads the same tap at once (a broadcast);
//   * each block stages its input span [m0*deci - (ntaps-1), (m0+B)*deci)
//     into shared memory once (coalesced reads, out-of-range positions
//     masked to zero instead of padding a copy in device memory), stored
//     phase-major (sample i at row i % deci, column i / deci) so that the
//     threads of a warp read consecutive words: no bank conflicts at any
//     deci;
//   * each thread accumulates with fmaf in a fixed tap order.  No TF32,
//     no tensor cores.
// Later work: a tensor-core banded form (bf16 split or TF32x3 wgmma) for
// long filters, and register blocking of several outputs per thread so
// one shared-memory read feeds several FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// Dynamic shared memory: [taps (ntaps) | span (deci rows of q_len)].
__global__ void fir_decimate_kernel(const float* __restrict__ x, long long n,
                                    const float* __restrict__ trev, int ntaps,
                                    int deci, float* __restrict__ y,
                                    long long m) {
  extern __shared__ float smem[];
  float* taps = smem;
  float* span = smem + ntaps;
  const int nout = blockDim.x;
  const int span_len = (nout - 1) * deci + ntaps;
  const int q_len = (span_len + deci - 1) / deci;
  const long long m0 = (long long)blockIdx.x * nout;
  const long long p0 = m0 * deci - (ntaps - 1);

  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) taps[k] = trev[k];
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const long long p = p0 + i;
    span[(i % deci) * q_len + i / deci] = (p >= 0 && p < n) ? x[p] : 0.0f;
  }
  __syncthreads();

  const long long mi = m0 + threadIdx.x;
  if (mi >= m) return;
  // output t needs span[t*deci + k] * trev[k]; sample t*deci + k sits at
  // row k % deci, column t + k / deci
  float acc = 0.0f;
  for (int r = 0; r < deci; ++r) {
    const float* row = span + r * q_len + threadIdx.x;
    for (int k = r, q = 0; k < ntaps; k += deci, ++q) {
      acc = fmaf(taps[k], row[q], acc);
    }
  }
  y[mi] = acc;
}

size_t smem_bytes(int threads, int ntaps, int deci) {
  const long long span_len = (long long)(threads - 1) * deci + ntaps;
  const long long q_len = (span_len + deci - 1) / deci;
  return sizeof(float) * (size_t)(ntaps + q_len * deci);
}

}  // namespace

// x: n f32; trev: ntaps f32 (taps reversed); y: m = ceil(n/deci) f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rr_fir_decimate(const void* x, long long n, const void* trev,
                               int ntaps, int deci, void* y, long long m,
                               void* stream) {
  if (ntaps < 1 || deci < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  int threads = kThreads;
  while (threads > 32 && smem_bytes(threads, ntaps, deci) > kMaxSmem) threads /= 2;
  const size_t smem = smem_bytes(threads, ntaps, deci);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (m + threads - 1) / threads;
  fir_decimate_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)trev, ntaps, deci, (float*)y, m);
  return (int)cudaGetLastError();
}

extern "C" const char* rr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
