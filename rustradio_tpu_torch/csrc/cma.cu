// Kernel F: the CMA blind equalizer's recurrence (reference src/cma.rs),
// one call's stream in one block.  For each of the n - ntaps + 1 windows
// w_n = x[n : n + ntaps]:
//
//   y_n = t_n . w_n
//   e   = R - (re(y)^2 + im(y)^2)
//   t_{n+1} = t_n + c_n conj(w_n),   c_n = (mu * e) * y_n
//
// It has no Pallas counterpart: it replaces the lax.scan of cma_equalize
// (rustradio_tpu/ops/cma.py:45).
//
// What bounds it on an H100: the dependent chain.  Each window's y needs
// the c of the window before it; bytes (16 a window) and operations (~16
// a tap) are nowhere near a limit.  Computed as written, a window's chain
// runs through the taps' update, the products, the sum over the taps (a
// five-step shuffle butterfly on one warp) and e: 277 cycles a window.
//
// What the design does about it: the delayed-update form.  Over a block
// of kBlock windows from window B, with the taps t_B that the windows
// before it left,
//
//   y_n = a_n + sum_{B <= m < n} c_m G[m, n],   a_n = t_B . w_n,
//   G[m, n] = conj(w_m) . w_n = sum_k conj(x[m + k]) x[n + k],
//
// exact in real arithmetic.  a_n and G read only t_B and x, so they are
// parallel work; a window's chain is one shuffle and eight f32 operations:
// c_{n-1} to every lane, the product c_{n-1} G[n-1, n] (2), its addition
// (1), |y|^2 (2), e (1), mu * e (1) and c (1).  One block of 256 threads a
// call:
//
//   * the walker (warp 0): lane j holds the partial sum of window B + j
//     and lane l taps l, l + 32, ... (kMaxTaps = 128: four a lane; the
//     wrapper raises above).  At step i lane i's partial is whole: it is
//     y_{B+i}; every lane computes e and c from its own partial, one
//     shuffle takes lane i's c to every lane, lanes j > i add its term
//     c G[i, j] and every lane updates its taps.  At a block's end the
//     lanes put the taps in shared memory and lane j computes the base of
//     window j of the next block.  (A walker with no shuffle on its chain,
//     every lane adding each window's newest terms itself, was slower on
//     the H100: its extra instructions and registers cost more than the
//     shuffle saves; PERF.md gives the times.)
//   * six producer warps (1-3, 5-7) compute the next tile's lag sums G[m,
//     j], m < j < kBlock, each directly over the taps, in runs of four of
//     a row that share their loads of x;
//   * the stager (warp 4, beside the walker on its warp scheduler, with
//     little to issue) copies each tile's samples into shared memory with
//     cp.async (16-byte copies where x is 16-byte aligned) and writes the
//     previous tile's outputs out;
//   * one __syncthreads() a tile of kTile windows hands the buffers on
//     (three sample tiles, two of lag sums, two of outputs).
//
// Numerics: every f32 operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), because nvcc contracts a*b+c into an FMA by
// default.  Blocks count from the call's start.  a_n: 32 lane sums, lane l
// from +0.0 over the products of taps l, l + 32, ... (those < ntaps), then
// folded in halves (16, 8, 4, 2, 1); G: from the k = 0 product up; a
// window's terms from the oldest up; the taps' update is the sequential
// one.  The plain PyTorch version (ops/kernels.py, cma_scan_plain) does the
// same operations in the same order, and the two agree bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 128;
constexpr int kSlots = kMaxTaps / 32;
constexpr int kBlock = 32;                         // windows a block (kernels.CMA_BLOCK)
constexpr int kPairs = kBlock * (kBlock - 1) / 2;  // lag sums a block
constexpr int kRun = 4;                            // lag sums of a row a thread takes
constexpr int kRuns = 136;  // runs of kRun a block: sum over m < 31 of ceil((31 - m) / 4)
constexpr int kTileBlocks = 8;
constexpr int kTile = kBlock * kTileBlocks;        // windows a tile
constexpr int kSpan = kTile + kBlock + kMaxTaps;   // samples a tile stages, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // the walker, the stager, six producers
constexpr int kProducers = 192;
// shared memory: three sample tiles, two tiles of lag sums, two of
// outputs, the taps, the (m, first j) of each run of lag sums
constexpr size_t kSmem = sizeof(float2) * (3 * kSpan + 2 * kTileBlocks * kPairs +
                                           2 * kTile + kMaxTaps) +
                         sizeof(unsigned short) * kRuns;

// where G[m, j] (m < j) lies in a block's lag sums: row m after rows < m
__host__ __device__ constexpr int tri(int m, int j) {
  return m * (kBlock - 1) - m * (m - 1) / 2 + (j - m - 1);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// c * g = (cr gr - ci gi, cr gi + ci gr)
__device__ __forceinline__ float2 cmul(float2 c, float2 g) {
  return make_float2(__fsub_rn(__fmul_rn(c.x, g.x), __fmul_rn(c.y, g.y)),
                     __fadd_rn(__fmul_rn(c.x, g.y), __fmul_rn(c.y, g.x)));
}

// conj(a) * b = (ar br + ai bi, ar bi - ai br)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Starts the copy of tile u's samples [u kTile, u kTile + span) into dst,
// zeros past n, without waiting: 16-byte copies of sample pairs where x is
// 16-byte aligned (every tile then starts on a pair), else 8-byte copies.
__device__ __forceinline__ void stage(float2* dst, const float2* __restrict__ x,
                                      long long n, long long u, int span, int tid,
                                      int nthreads) {
  const long long s0 = u * kTile;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    for (int q = tid; 2 * q < span; q += nthreads) {
      const long long s = s0 + 2 * q;
      if (s + 1 < n) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst + 2 * q)), "l"(x + s));
      } else {
        for (int h = 0; h < 2; ++h) {
          const bool in = s + h < n;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                           smem_addr(dst + 2 * q + h)), "l"(in ? x + s + h : x),
                       "r"(in ? 8 : 0));
        }
      }
    }
  } else {
    for (int i = tid; i < span; i += nthreads) {
      const bool in = s0 + i < n;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                       smem_addr(dst + i)), "l"(in ? x + s0 + i : x), "r"(in ? 8 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Tile u's lag sums into g (kTileBlocks blocks of kPairs) from its samples
// xt; blocks past the last window are skipped.  A thread takes a run of
// kRun sums of one row m, G[m, j0 .. j0 + kRun), whose four chains share
// the load of x[m + k] (a run past j = kBlock - 1 computes what it does
// not store).
__device__ __forceinline__ void lags(float2* g, const float2* xt, long long nwin,
                                     long long u, int ntaps,
                                     const unsigned short* runs, int tid,
                                     int nthreads) {
  for (int idx = tid; idx < kTileBlocks * kRuns; idx += nthreads) {
    const int b = idx / kRuns;
    if (u * kTile + b * kBlock >= nwin) break;
    const int mj = runs[idx - b * kRuns];
    const int m = mj >> 8, j0 = mj & 255;
    const float2* a = xt + b * kBlock + m;
    const float2* c = xt + b * kBlock + j0;
    float2 acc[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) acc[q] = cmulc(a[0], c[q]);
#pragma unroll 4
    for (int k = 1; k < ntaps; ++k) {
      const float2 av = a[k];
#pragma unroll
      for (int q = 0; q < kRun; ++q) acc[q] = cadd(acc[q], cmulc(av, c[k + q]));
    }
    float2* out = g + b * kPairs + tri(m, j0);
#pragma unroll
    for (int q = 0; q < kRun; ++q)
      if (j0 + q < kBlock) out[q] = acc[q];
  }
}

// Tile u's outputs to y, up to nwin.
__device__ __forceinline__ void flush(const float2* yt, float2* __restrict__ y,
                                      long long nwin, long long u, int tid,
                                      int nthreads) {
  const long long s0 = u * kTile;
  for (int i = tid; i < kTile && s0 + i < nwin; i += nthreads) y[s0 + i] = yt[i];
}

// The walker warp's state: lane l's taps l + 32 j, j < L, and its partial
// sum p of window l of the block being walked.
template <int L>
struct CmaWalker {
  float tr[L], ti[L];
  float2 p;

  __device__ __forceinline__ void load(const float2* __restrict__ taps, int ntaps,
                                       int lane) {
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

  // The taps after window w's step: t += (cr + i ci) * conj(w), w = xw[lane
  // + 32 j] (a slot past ntaps holds values that nothing reads).
  __device__ __forceinline__ void update(float2 c, const float2* xw, int lane) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float2 w = xw[lane + 32 * j];
      tr[j] = __fadd_rn(tr[j], __fadd_rn(__fmul_rn(c.x, w.x), __fmul_rn(c.y, w.y)));
      ti[j] = __fadd_rn(ti[j], __fsub_rn(__fmul_rn(c.y, w.x), __fmul_rn(c.x, w.y)));
    }
  }

  // The bases of the block whose window j reads xw[j .. j + ntaps): the
  // taps through shared memory st, then lane j's base a_j in p.  A tap
  // slot past ntaps adds +0.0 (a lane sum from +0.0 is never -0.0, so this
  // leaves it as it is); groups of eight lane sums past ntaps are skipped.
  __device__ __forceinline__ void bases(float2* st, const float2* xw, int ntaps,
                                        int lane) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int k = lane + 32 * j;
      if (k < ntaps) st[k] = make_float2(tr[j], ti[j]);
    }
    __syncwarp();
    float sr[32], si[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) sr[l] = si[l] = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int g8 = 0; g8 < 4; ++g8) {
        if (32 * j + 8 * g8 >= ntaps) break;  // uniform
#pragma unroll
        for (int l = 8 * g8; l < 8 * g8 + 8; ++l) {
          const int k = l + 32 * j;
          const float2 t = st[k];
          const float2 w = xw[lane + k];
          const bool on = k < ntaps;
          const float pr = __fsub_rn(__fmul_rn(t.x, w.x), __fmul_rn(t.y, w.y));
          const float pi = __fadd_rn(__fmul_rn(t.x, w.y), __fmul_rn(t.y, w.x));
          sr[l] = __fadd_rn(sr[l], on ? pr : 0.0f);
          si[l] = __fadd_rn(si[l], on ? pi : 0.0f);
        }
      }
    }
#pragma unroll
    for (int level = 0; level < 5; ++level) {
      const int off = 16 >> level;  // 16, 8, 4, 2, 1
#pragma unroll
      for (int l = 0; l < 16; ++l) {
        if (l < off) {
          sr[l] = __fadd_rn(sr[l], sr[l + off]);
          si[l] = __fadd_rn(si[l], si[l + off]);
        }
      }
    }
    p = make_float2(sr[0], si[0]);
  }

  // The cnt windows of a block: window i reads xw[i .. i + ntaps), gb holds
  // the block's lag sums, y_i goes to yo[i].  Lane i walks window i: at
  // step i its partial is whole, and it computes e and c; one shuffle
  // gives c to every lane, and lanes j > i add c's term G[i, j] to their
  // partials and every lane updates its taps.  Straight-line code: the
  // windows from cnt on (the last block of a call) take c = 0, which
  // leaves the taps as they are; a lane's partial is updated through a
  // select.
  __device__ __forceinline__ void walk(const float2* xw, const float2* gb, int cnt,
                                       float r, float mu, float2* yo, int lane) {
    float2 cb = make_float2(0.0f, 0.0f);  // c of window i - 1, every lane
#pragma unroll
    for (int i = 0; i < kBlock; ++i) {
      if (i >= 1) {
        const float2 t = cmul(cb, gb[tri(i - 1, lane > i - 1 ? lane : i)]);
        const bool on = lane >= i;
        const float px = __fadd_rn(p.x, t.x), py = __fadd_rn(p.y, t.y);
        p.x = on ? px : p.x;
        p.y = on ? py : p.y;
        update(cb, xw + i - 1, lane);
      }
      const float mu_i = i < cnt ? mu : 0.0f;
      const float e = __fsub_rn(r, __fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)));
      const float me = __fmul_rn(mu_i, e);
      const float2 c = make_float2(__fmul_rn(me, p.x), __fmul_rn(me, p.y));
      cb = make_float2(__shfl_sync(kFull, c.x, i), __shfl_sync(kFull, c.y, i));
    }
    update(cb, xw + kBlock - 1, lane);
    if (lane < cnt) yo[lane] = p;
  }
};

// Round t: the walker (warp 0) walks tile t; the stager (warp 4, on the
// walker's warp scheduler, with little to issue) stages tile t + 2's
// samples and writes tile t - 1's outputs; the six producers (warps 1-3,
// 5-7, two on each other scheduler) compute tile t + 1's lag sums.
template <int L>
__global__ void __launch_bounds__(kThreads, 1) cma_kernel(
    const float2* __restrict__ x, long long n, int ntaps, float r, float mu,
    float2* __restrict__ taps, float2* __restrict__ y) {
  extern __shared__ __align__(16) float2 smem[];
  float2* xs = smem;                                // [3][kSpan]
  float2* gs = xs + 3 * kSpan;                      // [2][kTileBlocks * kPairs]
  float2* ys = gs + 2 * kTileBlocks * kPairs;       // [2][kTile]
  float2* st = ys + 2 * kTile;                      // [kMaxTaps]
  unsigned short* runs = reinterpret_cast<unsigned short*>(st + kMaxTaps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ptid = (warp - 1 - (warp > 4)) * 32 + lane;  // a producer's rank
  const long long nwin = n - ntaps + 1;
  const long long tiles = (nwin + kTile - 1) / kTile;
  const int span = kTile + kBlock + ntaps - 1;
  CmaWalker<L> walker;
  if (warp == 0) {
    walker.load(taps, ntaps, lane);
  } else if (warp == 4) {
    stage(xs, x, n, 0, span, lane, 32);
    if (tiles > 1) stage(xs + kSpan, x, n, 1, span, lane, 32);
    cp_wait();
  } else {
    for (int i = ptid; i < kRuns; i += kProducers) {  // row m: (31 - m + 3) / 4 runs
      int m = 0, rest = i;
      while (rest >= (kBlock - m + 2) / kRun) rest -= (kBlock - m++ + 2) / kRun;
      runs[i] = (unsigned short)((m << 8) | (m + 1 + kRun * rest));
    }
  }
  __syncthreads();
  if (warp == 0)
    walker.bases(st, xs, ntaps, lane);
  else if (warp != 4)
    lags(gs, xs, nwin, 0, ntaps, runs, ptid, kProducers);
  __syncthreads();
  for (long long t = 0; t < tiles; ++t) {
    const int gb = (int)(t & 1);
    if (warp == 0) {
      const float2* xt = xs + (t % 3) * kSpan;
      for (int b = 0; b < kTileBlocks; ++b) {
        const long long n0 = t * kTile + b * kBlock;
        if (n0 >= nwin) break;
        const int cnt = (int)(nwin - n0 < kBlock ? nwin - n0 : kBlock);
        walker.walk(xt + b * kBlock, gs + (gb * kTileBlocks + b) * kPairs, cnt, r, mu,
                    ys + gb * kTile + b * kBlock, lane);
        if (n0 + kBlock < nwin) walker.bases(st, xt + (b + 1) * kBlock, ntaps, lane);
      }
    } else if (warp == 4) {
      if (t + 2 < tiles) stage(xs + ((t + 2) % 3) * kSpan, x, n, t + 2, span, lane, 32);
      if (t > 0) flush(ys + (gb ^ 1) * kTile, y, nwin, t - 1, lane, 32);
      cp_wait();
    } else if (t + 1 < tiles) {
      lags(gs + (gb ^ 1) * kTileBlocks * kPairs, xs + ((t + 1) % 3) * kSpan, nwin,
           t + 1, ntaps, runs, ptid, kProducers);
    }
    __syncthreads();
  }
  if (warp == 0)
    walker.store(taps, ntaps, lane);
  else if (warp == 4)
    flush(ys + ((tiles - 1) & 1) * kTile, y, nwin, tiles - 1, lane, 32);
}

template <int L>
cudaError_t launch(cudaStream_t stream, const float2* x, long long n, int ntaps,
                   float r, float mu, float2* taps, float2* y) {
  const cudaError_t e = cudaFuncSetAttribute(
      cma_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  cma_kernel<L><<<1, kThreads, kSmem, stream>>>(x, n, ntaps, r, mu, taps, y);
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
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* xs = (const float2*)x;
  float2* t = (float2*)taps;
  float2* ys = (float2*)y;
  switch ((ntaps + 31) / 32) {
    case 1: return (int)launch<1>(s, xs, n, ntaps, r, mu, t, ys);
    case 2: return (int)launch<2>(s, xs, n, ntaps, r, mu, t, ys);
    case 3: return (int)launch<3>(s, xs, n, ntaps, r, mu, t, ys);
    default: return (int)launch<kSlots>(s, xs, n, ntaps, r, mu, t, ys);
  }
}
