// Kernel B: the whole FM receive chain in one memory pass — the
// decimating FIR on both I/Q planes, the DC fold, then the quadrature
// discriminator with the polynomial fast_atan2.
//
// Replaces the three TPU kernels of rustradio_tpu/ops/pallas_kernels.py
// that compute this chain:
//   * _fm_chain_kernel (:394) — flat f32/bf16 planes, grid pipeline;
//   * _fm_i8_kernel (:448) — flat s8 planes, exact s32 MXU accumulation;
//   * _fm_chain_db_kernel (:553) — packed planes and ring windows, manual
//     double-buffered DMA, demod seam carried in the loop.
// One template over the plane type (float, __nv_bfloat16, int8_t) serves
// the flat, packed and windowed entry points: the caller gives the plane,
// its length and the index shift that maps output o to its input span.
//
// Each block computes the filtered I and Q for its outputs PLUS the one
// filtered sample before them, so the discriminator at a block's first
// output needs no seam repair (the TPU kernels fixed their tile seams
// outside the kernel, pallas_kernels.py:1017-1043, or carried them through
// a sequential grid).  The window's first output takes y[first-1] from
// `seed`; the thread that owns the window's last filtered sample writes it
// to `last`, so chunked launches compose into one continuous stream.
//
// Precision modes keep the JAX contracts (plane dtype and error budget),
// not the MXU mechanics: the host folds the 2/3 exact bf16 tap terms
// (w2/w3) or the scaled-s8 ladder (i8) into one effective f32 tap vector,
// and the kernel accumulates plane_value * tap with fmaf.  The DC term
// folds in after the dot: y = acc * scale + dc (scale 1/128 for s8 planes,
// whose value is x = (v + 1) / 128).
//
// What bounds it on an H100: device memory.  It reads 2 B (bf16) or 1 B
// (s8) per sample per plane and writes 4 B per output (deci 4: about 5 B
// per input sample at w3, 3 B at i8), against about 26 FMA per input
// sample at 49 taps.  The design keeps every intermediate (filtered
// planes, products, angles) in shared memory and registers; planes are
// read once with coalesced loads (plus a halo of ntaps samples per block).
// Later work: bf16 wgmma for w2/w3 and s8 IMMA for i8 (exact s32 under the
// same |acc| < 2^24 bound), TMA pipelining of the plane reads, and register
// blocking of several outputs per thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fast_atan2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// Filtered sample o:  y[o] = scale * sum_k trev[k] * X(o*deci + shift + k) + dc,
// X(p) = plane[p] for 0 <= p < L, else `pad`.
// Output j in [0, count):  out[j] = gain * fast_atan2(conj(y[first+j-1]) * y[first+j]),
// with y[first-1] taken from seed.  last = y[first+count-1].
//
// Block b holds blockDim.x filtered samples, t = 0..blockDim.x-1, sample t
// being y[first + j0 - 1 + t] with j0 = b * (blockDim.x - 1); it writes
// outputs j0 .. j0 + blockDim.x - 2.
// Dynamic shared memory: [taps | I span | Q span | y_I | y_Q].
template <typename T>
__global__ void fm_chain_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                                long long L, long long shift, float pad,
                                const float* __restrict__ trev, int ntaps, int deci,
                                long long first, long long count, float scale,
                                float dc, float gain, const float* __restrict__ seed,
                                float* __restrict__ out, float* __restrict__ last) {
  extern __shared__ float smem[];
  const int ny = blockDim.x;
  const int span_len = (ny - 1) * deci + ntaps;
  const int q_len = (span_len + deci - 1) / deci;
  float* taps = smem;
  float* sr = taps + ntaps;
  float* si = sr + q_len * deci;
  float* yr = si + q_len * deci;
  float* yi = yr + ny;

  const long long j0 = (long long)blockIdx.x * (ny - 1);
  const long long p0 = (first + j0 - 1) * deci + shift;

  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) taps[k] = trev[k];
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const long long p = p0 + i;
    const bool in = p >= 0 && p < L;
    const int s = (i % deci) * q_len + i / deci;
    sr[s] = in ? to_f32(xr[p]) : pad;
    si[s] = in ? to_f32(xi[p]) : pad;
  }
  __syncthreads();

  const int t = threadIdx.x;
  float ar = 0.0f, ai = 0.0f;
  for (int r = 0; r < deci; ++r) {
    const float* rowr = sr + r * q_len + t;
    const float* rowi = si + r * q_len + t;
    for (int k = r, q = 0; k < ntaps; k += deci, ++q) {
      const float w = taps[k];
      ar = fmaf(w, rowr[q], ar);
      ai = fmaf(w, rowi[q], ai);
    }
  }
  float fr = fmaf(ar, scale, dc);
  float fi = fmaf(ai, scale, dc);
  const long long jt = j0 - 1 + t;  // this sample is y[first + jt]
  if (jt < 0) {
    fr = seed[0];
    fi = seed[1];
  }
  yr[t] = fr;
  yi[t] = fi;
  if (jt == count - 1) {
    last[0] = fr;
    last[1] = fi;
  }
  __syncthreads();

  if (t >= 1 && jt < count) {
    const float pr = yr[t - 1], pi = yi[t - 1];
    const float dr = pr * fr + pi * fi;
    const float di = pr * fi - pi * fr;
    out[jt] = gain * rr::fast_atan2f(di, dr);
  }
}

size_t smem_bytes(int threads, int ntaps, int deci) {
  const long long span_len = (long long)(threads - 1) * deci + ntaps;
  const long long q_len = (span_len + deci - 1) / deci;
  return sizeof(float) * (size_t)(ntaps + 2 * q_len * deci + 2 * threads);
}

template <typename T>
int launch(const void* xr, const void* xi, long long L, long long shift, float pad,
           const void* trev, int ntaps, int deci, long long first, long long count,
           float scale, float dc, float gain, const void* seed, void* out, void* last,
           cudaStream_t stream) {
  int threads = kThreads;
  while (threads > 32 && smem_bytes(threads, ntaps, deci) > kMaxSmem) threads /= 2;
  const size_t smem = smem_bytes(threads, ntaps, deci);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fm_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (count + threads - 2) / (threads - 1);
  fm_chain_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)xr, (const T*)xi, L, shift, pad, (const float*)trev, ntaps, deci,
      first, count, scale, dc, gain, (const float*)seed, (float*)out, (float*)last);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bfloat16, 2 = int8.  Planes xr/xi hold L values;
// trev: ntaps f32 effective taps, reversed; seed: 2 f32; out: count f32;
// last: 2 f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rr_fm_chain(int dtype, const void* xr, const void* xi, long long L,
                           long long shift, float pad, const void* trev, int ntaps,
                           int deci, long long first, long long count, float scale,
                           float dc, float gain, const void* seed, void* out,
                           void* last, void* stream) {
  if (ntaps < 1 || deci < 1 || L < 0 || count < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(xr, xi, L, shift, pad, trev, ntaps, deci, first, count,
                           scale, dc, gain, seed, out, last, s);
    case 1:
      return launch<__nv_bfloat16>(xr, xi, L, shift, pad, trev, ntaps, deci, first,
                                   count, scale, dc, gain, seed, out, last, s);
    case 2:
      return launch<int8_t>(xr, xi, L, shift, pad, trev, ntaps, deci, first, count,
                            scale, dc, gain, seed, out, last, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
