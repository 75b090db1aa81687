// Kernel F: the CMA blind equalizer's recurrence (reference src/cma.rs),
// one call's stream in one block.  For each of the n - ntaps + 1 windows
// w = x[i : i + ntaps]:
//
//   y     = sum_k taps[k] * w[k]
//   e     = R - (re(y)^2 + im(y)^2)
//   taps += ((mu * e) * y) * conj(w)
//
// It has no Pallas counterpart: it replaces the lax.scan of cma_equalize
// (rustradio_tpu/ops/cma.py:45).
//
// What bounds it on an H100: the dependent chain.  Each window's y needs
// the taps that the window before it left, so the windows run one after
// the other; bytes (16 a window) and operations (~10 a tap) are nowhere
// near a limit.  One window's chain is the tap products, the sum over the
// taps, e, mu * e * y and the taps' update: about 15 f32 operations and,
// for the sum, a five-step butterfly of warp shuffles (chip_smoke.py counts
// it at the latencies it measures in the same run, tools/csrc/
// chain_calib.cu).
//
// What the design does about it: one block of two warps per call.
//   * the walker warp holds the taps in registers, lane l taps l, l + 32,
//     ... (kMaxTaps = 128: four a lane; the wrapper raises above), so the
//     sum over the taps is one partial sum a lane and a __shfl_xor_sync
//     butterfly (16, 8, 4, 2, 1), after which every lane holds the same y
//     (IEEE addition is commutative: both halves of an exchange agree bit
//     for bit), computes e and mu * e * y itself and updates its own taps;
//     it reads the windows from shared memory only, the next window's
//     samples fetched while the current one is reduced;
//   * the loader warp brings the next tile's samples into shared memory
//     (coalesced: lane l loads x[t0 + l + 32 j]) and writes the previous
//     tile's outputs out, so that neither waits on device memory;
//   * one __syncthreads() a tile hands the double buffers on.
//
// Numerics: every f32 operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), because nvcc contracts a*b+c into an FMA by
// default; a lane's partial sum starts at +0.0 and adds its taps' products
// in ascending tap order (a lane without a tap keeps +0.0), then the
// butterfly.  The plain PyTorch version (ops/kernels.py, cma_scan_plain)
// does the same operations in the same order, and the two agree bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 128;
constexpr int kSlots = kMaxTaps / 32;
constexpr int kTile = 1024;  // windows a tile
constexpr int kThreads = 64;  // warp 0 walks, warp 1 loads and flushes
constexpr unsigned kFull = 0xffffffffu;

// The loader: the samples of the windows [t0, t0 + cnt) of tile `tile`,
// cnt + ntaps - 1 of them.
__device__ __forceinline__ void load_tile(const float2* __restrict__ x,
                                          long long nwin, int ntaps,
                                          long long tile, float2* s, int lane) {
  const long long t0 = tile * kTile;
  const long long rest = nwin - t0;
  const int cnt = (int)(rest < kTile ? rest : kTile);
  const int len = cnt + ntaps - 1;
  for (int i = lane; i < len; i += 32) s[i] = x[t0 + i];
}

__device__ __forceinline__ void flush_tile(const float2* s, long long nwin,
                                           long long tile,
                                           float2* __restrict__ y, int lane) {
  const long long t0 = tile * kTile;
  const long long rest = nwin - t0;
  const int cnt = (int)(rest < kTile ? rest : kTile);
  for (int i = lane; i < cnt; i += 32) y[t0 + i] = s[i];
}

// The walker warp's state: lane l's taps l + 32 j, j < L.
template <int L>
struct CmaWalker {
  float tr[L], ti[L];

  __device__ __forceinline__ void load(const float2* __restrict__ taps,
                                       int ntaps, int lane) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int k = lane + 32 * j;
      const float2 t = k < ntaps ? taps[k] : make_float2(0.0f, 0.0f);
      tr[j] = t.x;
      ti[j] = t.y;
    }
  }

  __device__ __forceinline__ void store(float2* __restrict__ taps, int ntaps,
                                        int lane) const {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int k = lane + 32 * j;
      if (k < ntaps) taps[k] = make_float2(tr[j], ti[j]);
    }
  }

  // The cnt windows of a tile: window i reads s[i .. i + ntaps).
  __device__ __forceinline__ void tile(const float2* s, int cnt, int ntaps,
                                       float r, float mu, float2* out,
                                       int lane) {
    float wr[L], wi[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int k = lane + 32 * j;
      const float2 w = k < ntaps ? s[k] : make_float2(0.0f, 0.0f);
      wr[j] = w.x;
      wi[j] = w.y;
    }
    for (int i = 0; i < cnt; ++i) {
      float ar = 0.0f, ai = 0.0f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (lane + 32 * j < ntaps) {
          const float pr = __fsub_rn(__fmul_rn(tr[j], wr[j]),
                                     __fmul_rn(ti[j], wi[j]));
          const float pi = __fadd_rn(__fmul_rn(tr[j], wi[j]),
                                     __fmul_rn(ti[j], wr[j]));
          ar = __fadd_rn(ar, pr);
          ai = __fadd_rn(ai, pi);
        }
      }
      // the next window's samples, while this one is reduced (the tile's
      // buffer holds kTile + kMaxTaps samples, so the read past the last
      // window stays inside it)
      float nr[L], ni[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int k = lane + 32 * j;
        const float2 w = k < ntaps ? s[i + 1 + k] : make_float2(0.0f, 0.0f);
        nr[j] = w.x;
        ni[j] = w.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ar = __fadd_rn(ar, __shfl_xor_sync(kFull, ar, off));
        ai = __fadd_rn(ai, __shfl_xor_sync(kFull, ai, off));
      }
      const float e = __fsub_rn(r, __fadd_rn(__fmul_rn(ar, ar),
                                             __fmul_rn(ai, ai)));
      const float me = __fmul_rn(mu, e);
      const float cr = __fmul_rn(me, ar);
      const float ci = __fmul_rn(me, ai);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (lane + 32 * j < ntaps) {
          // (cr + i ci) * conj(wr + i wi)
          const float ur = __fadd_rn(__fmul_rn(cr, wr[j]), __fmul_rn(ci, wi[j]));
          const float ui = __fsub_rn(__fmul_rn(ci, wr[j]), __fmul_rn(cr, wi[j]));
          tr[j] = __fadd_rn(tr[j], ur);
          ti[j] = __fadd_rn(ti[j], ui);
        }
        wr[j] = nr[j];
        wi[j] = ni[j];
      }
      if (lane == 0) out[i] = make_float2(ar, ai);
    }
  }
};

// Round t: the walker walks tile t, the loader brings tile t + 1 and
// writes tile t - 1 out.
template <int L>
__global__ void __launch_bounds__(kThreads) cma_kernel(
    const float2* __restrict__ x, long long nwin, int ntaps, float r, float mu,
    float2* __restrict__ taps, float2* __restrict__ y) {
  __shared__ float2 s_x[2][kTile + kMaxTaps];
  __shared__ float2 s_y[2][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (nwin + kTile - 1) / kTile;
  CmaWalker<L> walker;
  if (warp == 0)
    walker.load(taps, ntaps, lane);
  else
    load_tile(x, nwin, ntaps, 0, s_x[0], lane);
  __syncthreads();
  for (long long t = 0; t <= tiles; ++t) {
    const int buf = (int)(t & 1);
    if (warp == 0) {
      if (t < tiles) {
        const long long rest = nwin - t * kTile;
        walker.tile(s_x[buf], (int)(rest < kTile ? rest : kTile), ntaps, r, mu,
                    s_y[buf], lane);
      }
    } else {
      if (t + 1 < tiles) load_tile(x, nwin, ntaps, t + 1, s_x[buf ^ 1], lane);
      if (t > 0) flush_tile(s_y[buf ^ 1], nwin, t - 1, y, lane);
    }
    __syncthreads();
  }
  if (warp == 0) walker.store(taps, ntaps, lane);
}

template <int L>
cudaError_t launch(cudaStream_t stream, const float2* x, long long nwin,
                   int ntaps, float r, float mu, float2* taps, float2* y) {
  cma_kernel<L><<<1, kThreads, 0, stream>>>(x, nwin, ntaps, r, mu, taps, y);
  return cudaGetLastError();
}

}  // namespace

// x: n complex64 (float2) samples; taps: ntaps complex64 on the device, the
// starting taps, overwritten with the final ones; y: n - ntaps + 1
// complex64 outputs.  r and mu: the desired modulus and the step size, f32.
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for ntaps outside 1..128 or n < ntaps.
extern "C" int rr_cma_equalize(const void* x, long long n, int ntaps, float r,
                               float mu, void* taps, void* y, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || n < ntaps)
    return (int)cudaErrorInvalidValue;
  const long long nwin = n - ntaps + 1;
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* xs = (const float2*)x;
  float2* t = (float2*)taps;
  float2* ys = (float2*)y;
  switch ((ntaps + 31) / 32) {
    case 1: return (int)launch<1>(s, xs, nwin, ntaps, r, mu, t, ys);
    case 2: return (int)launch<2>(s, xs, nwin, ntaps, r, mu, t, ys);
    case 3: return (int)launch<3>(s, xs, nwin, ntaps, r, mu, t, ys);
    default: return (int)launch<kSlots>(s, xs, nwin, ntaps, r, mu, t, ys);
  }
}
