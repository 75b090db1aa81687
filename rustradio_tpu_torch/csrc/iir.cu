// Kernel G: the reference's IIR filter (src/iir_filter.rs:84-101), one
// call's stream in one block:
//
//   y[n] = taps[0] * x[n] + sum_{i >= 1} taps[i] * y[n - i]
//
// from a history of the last `order` outputs (most recent first).  It has
// no Pallas counterpart: it replaces the lax.scan of iir_filter
// (rustradio_tpu/ops/iir.py:68).
//
// What bounds it on an H100: the dependent chain.  y[n] needs y[n - 1], so
// the samples run one after the other on one lane; 8 bytes and 2 * order + 1
// operations a sample are nowhere near a limit.  The summation order is
// fixed so that the chain is as short as it can be: the terms that read
// only x[n] and the older outputs first, from the oldest (taps[order] *
// y[n - order]) down to taps[2] * y[n - 2], and the most recent term,
// taps[1] * y[n - 1], last.  Everything but that last multiply and add can
// run while y[n - 1] is still being formed, so the chain is two dependent
// operations a sample, whatever the order of the filter.
//
// What the design does about it: one block of two warps per call.
//   * the walker, lane 0 of warp 0, keeps the history in registers
//     (compiled per order 1..8; up to kMaxOrder = 32 through a predicated
//     general form; the wrapper raises above) and touches only registers
//     and shared memory, four samples a shared-memory access;
//   * warp 1 loads the next tile of x into shared memory (coalesced) and
//     writes the previous tile's outputs out;
//   * one __syncthreads() a tile hands the double buffers on.
//
// Numerics: every f32 operation is rounded on its own (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract a*b+c into an FMA.  The plain
// PyTorch version (ops/kernels.py, iir_scan_plain) does the same
// operations in the same order, and the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;
constexpr int kTile = 2048;   // samples a tile (a multiple of 4)
constexpr int kThreads = 64;  // warp 0 walks, warp 1 loads and flushes

struct Taps {
  float t[kMaxOrder + 1];
  int order;
};

// O > 0: an order-O filter; O == 0: any order up to kMaxOrder, the terms
// past the filter's order predicated off.
template <int O>
struct IirWalker {
  static constexpr int kH = O > 0 ? O : kMaxOrder;
  float h[kH];

  __device__ __forceinline__ void load(const Taps& k, const float* hist) {
#pragma unroll
    for (int j = 0; j < kH; ++j) h[j] = (O > 0 || j < k.order) ? hist[j] : 0.0f;
  }

  __device__ __forceinline__ float step(const Taps& k, float x) {
    float acc = __fmul_rn(k.t[0], x);
#pragma unroll
    for (int i = kH; i >= 2; --i)
      if (O > 0 || i <= k.order) acc = __fadd_rn(acc, __fmul_rn(k.t[i], h[i - 1]));
    const float y = __fadd_rn(acc, __fmul_rn(k.t[1], h[0]));
#pragma unroll
    for (int j = kH - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = y;
    return y;
  }

  __device__ __forceinline__ void tile(const Taps& k, const float* sx, int cnt,
                                       float* sy) {
    const float4* x4 = reinterpret_cast<const float4*>(sx);
    float4* y4 = reinterpret_cast<float4*>(sy);
    int i = 0;
    for (; i + 4 <= cnt; i += 4) {
      const float4 v = x4[i >> 2];
      float4 o;
      o.x = step(k, v.x);
      o.y = step(k, v.y);
      o.z = step(k, v.z);
      o.w = step(k, v.w);
      y4[i >> 2] = o;
    }
    for (; i < cnt; ++i) sy[i] = step(k, sx[i]);
  }
};

__device__ __forceinline__ int tile_len(long long n, long long tile) {
  const long long rest = n - tile * kTile;
  return (int)(rest < kTile ? rest : kTile);
}

template <int O>
__global__ void __launch_bounds__(kThreads) iir_kernel(
    const float* __restrict__ x, long long n, Taps k,
    const float* __restrict__ hist, float* __restrict__ y) {
  __shared__ __align__(16) float s_x[2][kTile];
  __shared__ __align__(16) float s_y[2][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (n + kTile - 1) / kTile;
  IirWalker<O> walker;
  if (threadIdx.x == 0) walker.load(k, hist);
  if (warp == 1)
    for (int i = lane; i < tile_len(n, 0); i += 32) s_x[0][i] = x[i];
  __syncthreads();
  for (long long t = 0; t <= tiles; ++t) {
    const int buf = (int)(t & 1);
    if (warp == 0) {
      if (threadIdx.x == 0 && t < tiles)
        walker.tile(k, s_x[buf], tile_len(n, t), s_y[buf]);
      __syncwarp();
    } else {
      if (t + 1 < tiles) {
        const long long i0 = (t + 1) * kTile;
        const int len = tile_len(n, t + 1);
        for (int i = lane; i < len; i += 32) s_x[buf ^ 1][i] = x[i0 + i];
      }
      if (t > 0) {
        const long long i0 = (t - 1) * kTile;
        const int len = tile_len(n, t - 1);
        for (int i = lane; i < len; i += 32) y[i0 + i] = s_y[buf ^ 1][i];
      }
    }
    __syncthreads();
  }
}

template <int O>
cudaError_t launch(cudaStream_t stream, const float* x, long long n,
                   const Taps& k, const float* hist, float* y) {
  iir_kernel<O><<<1, kThreads, 0, stream>>>(x, n, k, hist, y);
  return cudaGetLastError();
}

}  // namespace

// x: n f32; taps: ntaps host floats (order ntaps - 1, 1..32); hist: order
// f32 on the device, the last outputs before x[0], most recent first; y: n
// f32.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for an order outside 1..32.  n == 0 launches
// nothing.
extern "C" int rr_iir_filter(const void* x, long long n, const float* taps,
                             int ntaps, const void* hist, void* y,
                             void* stream) {
  const int order = ntaps - 1;
  if (order < 1 || order > kMaxOrder || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Taps k;
  for (int i = 0; i <= kMaxOrder; ++i) k.t[i] = i < ntaps ? taps[i] : 0.0f;
  k.order = order;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xs = (const float*)x;
  const float* h = (const float*)hist;
  float* ys = (float*)y;
  switch (order) {
    case 1: return (int)launch<1>(s, xs, n, k, h, ys);
    case 2: return (int)launch<2>(s, xs, n, k, h, ys);
    case 3: return (int)launch<3>(s, xs, n, k, h, ys);
    case 4: return (int)launch<4>(s, xs, n, k, h, ys);
    case 5: return (int)launch<5>(s, xs, n, k, h, ys);
    case 6: return (int)launch<6>(s, xs, n, k, h, ys);
    case 7: return (int)launch<7>(s, xs, n, k, h, ys);
    case 8: return (int)launch<8>(s, xs, n, k, h, ys);
    default: return (int)launch<0>(s, xs, n, k, h, ys);
  }
}
