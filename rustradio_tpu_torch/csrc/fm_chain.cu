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
// Flat f32 planes under a bf16 or s8 precision come as two more source
// types (F32AsBf16, F32AsS8 in fir_core.cuh): the kernel rounds each value
// as it loads it, to the value the cast plane would hold, so no cast runs
// before it and every output has the bits of the cast planes' launch.
//
// Each block stages one column more than its tile needs, and a helper
// warp (one lane per plane) computes the one filtered sample before the
// tile while the other warps compute theirs, in the same tap order and so
// to the same bits as the neighbouring block; the discriminator at a
// block's first output therefore needs no seam repair (the TPU kernels
// fixed their tile seams outside the kernel, pallas_kernels.py:1017-1043,
// or carried them through a sequential grid).  The window's first output
// takes y[first-1] from `seed` (a null pointer means zeros); the thread
// that owns the window's last filtered sample writes it to `last`, so
// chunked launches compose into one continuous stream.
//
// Precision modes keep the JAX contracts (plane dtype and error budget),
// not the MXU mechanics: the host folds the 2/3 exact bf16 tap terms
// (w2/w3) or the scaled-s8 ladder (i8) into one effective f32 tap vector,
// and the kernel accumulates plane_value * tap with fmaf.  The DC term
// folds in after the dot: y = acc * scale + dc (scale 1/128 for s8 planes,
// whose value is x = (v + 1) / 128).
//
// What bounds it on an H100: device memory.  It reads 2 B (bf16) or 1 B
// (s8) per sample per plane of packed planes, 4 B of flat f32 planes in
// every precision, and writes 4 B per output: packed at deci 4 and 2^24
// samples 83.9 MB (w3) or 50.3 MB (i8), 25 or 15 us at 3.35 TB/s, against
// 411 M FMA (12 us); flat at deci 1 and 2^26 samples (rtl_fm --rtl_u8)
// 537 MB of planes and 268 MB of audio, 240 us, against 6.6 G FMA (196
// us).  What the design does about it is the core's (fir_core.cuh): the
// planes come in as 16-byte vectors (4 f32, 8 bf16 or 16 s8) with the ends
// masked, tiles start at multiples of the tile size, and each thread
// computes R consecutive outputs of both planes from register windows, so
// the 49-tap dot product costs about a sixth of the shared-memory loads of
// one output per thread.  Measured on an H100 at 700 W at 39% (packed w3)
// and 25% (packed i8) of the memory bound, and at 43% on flat f32 planes
// under w3 at deci 1 (0.562 ms at 2^26, against 0.584 ms on bf16 planes
// cast beforehand); what is left is in fir_core.cuh.  Every intermediate
// (filtered planes, products, angles) stays in shared memory and registers;
// each thread writes its R outputs as float4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_atan2.cuh"
#include "fir_core.cuh"

namespace {

using namespace rr::fir;

constexpr int kHelper = 32;  // the warp that computes the sample before the tile

// Filtered sample o:  y[o] = scale * sum_k trev[k] * X(o*deci + shift + k) + dc,
// X(p) = plane[p] for 0 <= p < L, else `pad`.
// Output j in [0, count):  out[j] = gain * fast_atan2(conj(y[first+j-1]) * y[first+j]),
// with y[first-1] taken from seed.  last = y[first+count-1].
//
// Block b computes outputs [b*tile, (b+1)*tile); thread t < nmain owns R
// of them, threads nmain and nmain + 1 the filtered I and Q before the tile.
// Dynamic shared memory:
// [taps | I rows | Q rows | prev I (nmain + 1) | prev Q (nmain + 1)].
// The launch bounds cap the registers at 75 a thread: shared memory lets
// five blocks of the usual shape (128 + 32 threads) share an SM, and the
// staging pass would otherwise take registers that leave room for three.
template <typename T, int R, int D>
__global__ void __launch_bounds__(256 + kHelper, 3)
fm_chain_kernel(const T* __restrict__ xr, const T* __restrict__ xi, long long L,
                long long shift, float pad, const float* __restrict__ trev, Tile g,
                long long first, long long count, float scale, float dc, float gain,
                const float* __restrict__ seed, float* __restrict__ out,
                float* __restrict__ last) {
  extern __shared__ __align__(16) float smem[];
  const int nmain = blockDim.x - kHelper;
  const int plane_stride = g.nphase * g.row_len;
  float* hp = smem;
  float* span = hp + g.nphase * g.tstride;
  float* prev_r = span + 2 * plane_stride;
  float* prev_i = prev_r + nmain + 1;

  const long long j0 = (long long)blockIdx.x * g.tile;
  const long long p0 = (first + j0 - 1) * g.deci + shift;  // one column of lead
  stage_taps<D>(hp, trev, g, threadIdx.x, blockDim.x);
  const T* const planes[2] = {xr, xi};
  stage_span<T, R, D, 2>(span, plane_stride, g, planes, L, p0, pad, threadIdx.x,
                         blockDim.x);
  __syncthreads();

  const int t = threadIdx.x;
  const long long jt = j0 + (long long)t * R;  // this thread's first output
  const bool active = t < nmain && t * R < g.tile && jt < count;
  float fr[R], fi[R];
  if (active) {
    float acc[2][R];
    accumulate<R, 2, 1>(span, plane_stride, g, hp, t, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fr[r] = fmaf(acc[0][r], scale, dc);
      fi[r] = fmaf(acc[1][r], scale, dc);
      if (jt + r == count - 1) {
        last[0] = fr[r];
        last[1] = fi[r];
      }
    }
    prev_r[t + 1] = fr[R - 1];
    prev_i[t + 1] = fi[R - 1];
  } else if (t >= nmain && t < nmain + 2) {
    const int pl = t - nmain;
    float v;
    if (j0 == 0) {
      v = seed != nullptr ? seed[pl] : 0.0f;
    } else {
      v = fmaf(accumulate_one<R>(span + pl * plane_stride, g, hp), scale, dc);
    }
    (pl ? prev_i : prev_r)[0] = v;
  }
  __syncthreads();

  if (active) {
    float pr = prev_r[t], pi = prev_i[t];
    float res[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dr = pr * fr[r] + pi * fi[r];
      const float di = pr * fi[r] - pi * fr[r];
      res[r] = gain * rr::fast_atan2f(di, dr);
      pr = fr[r];
      pi = fi[r];
    }
    store_run<R>(out + jt, res, count - jt);
  }
}

template <typename T, int R, int D>
int launch_r(const void* xr, const void* xi, long long L, long long shift, float pad,
             const void* trev, int ntaps, int deci, long long first, long long count,
             float scale, float dc, float gain, const void* seed, void* out,
             void* last, const Shape& s, size_t smem, cudaStream_t stream) {
  static size_t allowed = 0;
  cudaError_t e = allow_smem(fm_chain_kernel<T, R, D>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const Tile g = make_tile<R>(s.tile, 1, ntaps, deci);
  const long long blocks = (count + s.tile - 1) / s.tile;
  fm_chain_kernel<T, R, D><<<(unsigned)blocks, s.threads + kHelper, smem, stream>>>(
      (const T*)xr, (const T*)xi, L, shift, pad, (const float*)trev, g, first, count,
      scale, dc, gain, (const float*)seed, (float*)out, (float*)last);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xr, const void* xi, long long L, long long shift, float pad,
           const void* trev, int ntaps, int deci, long long first, long long count,
           float scale, float dc, float gain, const void* seed, void* out, void* last,
           cudaStream_t stream) {
  Shape s;
  size_t smem;
  // two planes, one column of lead, two carried words per computing thread
  if (!pick_shape(ntaps, deci, count, 2, 1, 2, 2, &s, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* fn = launch_r<T, 4, 0>;
  if (s.r == 8) {
    switch (fixed_deci(s, ntaps, deci)) {
      case 1: fn = launch_r<T, 8, 1>; break;
      case 2: fn = launch_r<T, 8, 2>; break;
      case 4: fn = launch_r<T, 8, 4>; break;
      default: fn = launch_r<T, 8, 0>;
    }
  }
  return fn(xr, xi, L, shift, pad, trev, ntaps, deci, first, count, scale, dc, gain, seed,
            out, last, s, smem, stream);
}

}  // namespace

// dtype: 0 = float, 1 = bfloat16, 2 = int8, 3 = float rounded to bfloat16,
// 4 = float rounded to int8 (the s8 value; pad and scale as for 2).
// Planes xr/xi hold L values;
// trev: ntaps f32 effective taps, reversed; seed: 2 f32 or null (zeros);
// out: count f32; last: 2 f32.  Returns the cudaError_t of the launch (0
// on success).
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
    case 3:
      return launch<rr::fir::F32AsBf16>(xr, xi, L, shift, pad, trev, ntaps, deci,
                                        first, count, scale, dc, gain, seed, out,
                                        last, s);
    case 4:
      return launch<rr::fir::F32AsS8>(xr, xi, L, shift, pad, trev, ntaps, deci,
                                      first, count, scale, dc, gain, seed, out, last,
                                      s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
