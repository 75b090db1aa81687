// Kernel H: the critically sampled polyphase channelizer and the power of
// each channel, in one pass over the capture.  With M channels, L taps a
// branch (the prototype h of L*M taps) and zero history,
//
//   f[i, m] = x[i*M - m]                      (0 before the capture)
//   v[i, m] = sum_{l < L} h[l*M + m] f[i - l, m]
//   y[i, k] = sum_{m < M} v[i, m] e^{+2 pi i k m / M}
//   power[k] = mean_i |y[i, k]|^2
//
// y is M times the inverse DFT of v over the branches, which is what the
// inverse DFT without its 1/M is: there is no scale to apply.
//
// It replaces no TPU kernel: the JAX package's channelizer
// (rustradio_tpu/parallel/channelizer.py, pfb_channelize) is jnp code, its
// inverse DFT a TPU-only MXU product (_idft_mxu).  The port's plain
// version (ops/kernels.py, pfb_channelize_plain) is that jnp code in torch
// ops: the frames as a padded copy, the branch filter as L shifted
// multiply-adds over the whole (frames, M) matrix, a batched cuFFT and a
// scale, then the power as two more passes, each a trip through device
// memory.
//
// What bounds it on an H100: bytes.  It reads 8 B and writes 8 B a sample
// (2^28 samples: 4.29 GB, 1.28 ms at 3.35 TB/s) against 4L + 5 log2 M + 3
// f32 operations a sample (70 at M = 128, L = 8: 0.28 ms at 67 TFLOP/s).
//
// What the design does about it: each input sample is read from device
// memory once and each output written once; everything between stays in
// registers and shared memory.  A block walks tiles of kTile outputs (T =
// kTile / M frames), the persistent grid over every SM:
//
//   1. the branch filter: a thread owns branch m over a run of frames
//      (threads of a warp on neighbouring branches, so each load is
//      coalesced), keeps the last 15 frames of its branch and its L taps in
//      registers, and writes v[i, m] into the tile in shared memory.  A
//      run's first frames re-read the 15 before it (L - 1 of them loaded),
//      which L1 and L2 serve;
//   2. the inverse DFT over m as two passes, M = R S (m = S a + b, k = c +
//      R d): an R-point DFT over a for each (frame, b) in registers, times
//      the twiddle e^{2 pi i c b / M} (a table each block computes once in
//      float64, sincospi, rounded to f32), written back in place; then an
//      S-point DFT over b for each (frame, c), whose outputs y[i, c + R d]
//      go straight to device memory: R consecutive channels of a frame from
//      R neighbouring threads, so every store is coalesced;
//   3. the power: each thread sums |y|^2 of its channels over its frames in
//      f32 in registers; the block adds its threads' sums in a fixed order
//      and writes one row of partial sums (grid, M), which the wrapper adds
//      up in float64.  No atomics: the channel power is the same from run to
//      run on one card.
//
// The small DFTs are radix-2 over registers with the 32nd roots of unity
// as constants (float64 values rounded to f32).  The tile in shared memory
// takes one float2 of padding after every 16, so that the filter's stores
// and both passes' loads hit distinct banks at M = 128 and 256.  Numerics:
// f32 throughout, fmaf in the filter in tap order; the outputs are not
// bit-equal to cuFFT's, and are held to the float64 DDC reference.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;          // channel-matrix entries a tile
constexpr int kPhys = kTile + kTile / 16;
constexpr int kRun = 8;              // frames a thread filters at once
constexpr int kMaxL = 16;            // taps a branch
constexpr int kHalo = kMaxL - 1;     // frames a run keeps from before it

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

__host__ __device__ constexpr int bitrev(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | bitrev(i >> 1, bits - 1);
}

// the tile's shared index: one float2 of padding after every 16
__device__ __forceinline__ int phys(int j) { return j + (j >> 4); }

// cos(2 pi e / 32) for 0 <= e <= 8, float64 values rounded to f32
__device__ __forceinline__ float cos32(int e) {
  switch (e) {
    case 0: return 1.0f;
    case 1: return (float)0.98078528040323044913;
    case 2: return (float)0.92387953251128675613;
    case 3: return (float)0.83146961230254523708;
    case 4: return (float)0.70710678118654752440;
    case 5: return (float)0.55557023301960222474;
    case 6: return (float)0.38268343236508977173;
    case 7: return (float)0.19509032201612826785;
    default: return 0.0f;
  }
}

// a * e^{2 pi i e / 32}, 0 <= e < 16 (e is a constant once unrolled)
__device__ __forceinline__ float2 turn(float2 a, int e) {
  if (e == 0) return a;
  if (e == 8) return make_float2(-a.y, a.x);
  const float c = e <= 8 ? cos32(e) : -cos32(16 - e);
  const float s = e <= 8 ? cos32(8 - e) : cos32(e - 8);
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// one radix-2 stage of dft<N>: the DFTs of H points into DFTs of 2H
template <int N, int H>
__device__ __forceinline__ void stages(float2 (&t)[N]) {
  if constexpr (H < N) {
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += 2 * H) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float2 a = t[j0 + j];
        const float2 b = turn(t[j0 + j + H], j * (16 / H));
        t[j0 + j] = make_float2(a.x + b.x, a.y + b.y);
        t[j0 + j + H] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
    stages<N, 2 * H>(t);
  }
}

// v[k] <- sum_n v[n] e^{+2 pi i k n / N}, N a power of two up to 32:
// radix-2 decimation in time over registers
template <int N>
__device__ __forceinline__ void dft(float2 (&v)[N]) {
  constexpr int kBits = log2i(N);
  float2 t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[bitrev(i, kBits)] = v[i];
  stages<N, 1>(t);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = t[i];
}

// f[g, m] = x[g*M - m], zero before the capture and past the last frame
template <int M>
__device__ __forceinline__ float2 frame(const float2* __restrict__ x, long long g,
                                        int m, long long nframes) {
  const long long s = g * M - m;
  return (s >= 0 && g < nframes) ? x[s] : make_float2(0.0f, 0.0f);
}

template <int M>
__global__ void __launch_bounds__(kThreads, M >= 512 ? 1 : 2)
pfb_kernel(const float2* __restrict__ x, long long nframes,
           const float* __restrict__ taps, int L, float2* __restrict__ y,
           float* __restrict__ partial) {
  constexpr int kR = 1 << ((log2i(M) + 1) / 2);  // the first DFT, over a
  constexpr int kS = M / kR;                     // the second, over b
  constexpr int kT = kTile / M;                  // frames a tile
  constexpr int kBranches = M > kThreads ? M / kThreads : 1;  // a thread's
  constexpr int kSeg = kTile / (kThreads * kBranches);        // frames of each
  static_assert(kSeg % kRun == 0 && kThreads % kR == 0, "tile shape");
  static_assert((kT * kS) % kThreads == 0 && (kT * kR) % kThreads == 0,
                "whole passes");

  extern __shared__ float2 smem[];
  float2* buf = smem;           // the tile, kT frames of M, padded
  float2* tw = smem + kPhys;    // tw[c * kS + b] = e^{2 pi i c b / M}
  const int tid = threadIdx.x;
  for (int j = tid; j < M; j += kThreads) {
    double sn, cs;  // the argument 2 c b / M is exact: M is a power of two
    sincospi(2.0 * (j / kS) * (j % kS) / M, &sn, &cs);
    tw[j] = make_float2((float)cs, (float)sn);
  }

  float pw[kS];  // |y|^2 of channels c + kR d, c = tid % kR
#pragma unroll
  for (int d = 0; d < kS; ++d) pw[d] = 0.0f;

  const long long tiles = (nframes + kT - 1) / kT;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long g0 = tile * kT;

    // 1. the branch filter into the tile
    for (int u = 0; u < kBranches; ++u) {
      const int m = kBranches == 1 ? tid % M : tid + kThreads * u;
      const int f0 = kBranches == 1 ? (tid / M) * kSeg : 0;
      float h[kMaxL];
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) h[l] = l < L ? taps[l * M + m] : 0.0f;
      float2 w[kHalo + kRun];  // w[q]: frame g0 + f0 + r0 - kHalo + q
#pragma unroll
      for (int q = 0; q < kHalo; ++q)
        w[q] = q >= kMaxL - L ? frame<M>(x, g0 + f0 - kHalo + q, m, nframes)
                              : make_float2(0.0f, 0.0f);
#pragma unroll 1
      for (int r0 = 0; r0 < kSeg; r0 += kRun) {
#pragma unroll
        for (int q = 0; q < kRun; ++q)
          w[kHalo + q] = frame<M>(x, g0 + f0 + r0 + q, m, nframes);
        float2 acc[kRun];
#pragma unroll
        for (int r = 0; r < kRun; ++r) acc[r] = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          if (l < L) {
#pragma unroll
            for (int r = 0; r < kRun; ++r) {
              acc[r].x = fmaf(h[l], w[kHalo + r - l].x, acc[r].x);
              acc[r].y = fmaf(h[l], w[kHalo + r - l].y, acc[r].y);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRun; ++r) buf[phys((f0 + r0 + r) * M + m)] = acc[r];
#pragma unroll
        for (int q = 0; q < kHalo; ++q) w[q] = w[q + kRun];
      }
    }
    __syncthreads();

    // 2. the R-point DFTs over a, each output times its twiddle, in place
#pragma unroll 1
    for (int it = tid; it < kT * kS; it += kThreads) {
      const int b = it % kS;
      const int base = (it / kS) * M + b;
      float2 v[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) v[a] = buf[phys(base + kS * a)];
      dft<kR>(v);
#pragma unroll
      for (int c = 1; c < kR; ++c) v[c] = cmul(v[c], tw[c * kS + b]);
#pragma unroll
      for (int c = 0; c < kR; ++c) buf[phys(base + kS * c)] = v[c];
    }
    __syncthreads();

    // 3. the S-point DFTs over b: y[g, c + R d] to device memory, |y|^2
#pragma unroll 1
    for (int it = tid; it < kT * kR; it += kThreads) {
      const int fr = it / kR;
      const int c = it % kR;
      const int base = fr * M + kS * c;
      float2 z[kS];
#pragma unroll
      for (int b = 0; b < kS; ++b) z[b] = buf[phys(base + b)];
      dft<kS>(z);
      const long long g = g0 + fr;
      if (g < nframes) {
        float2* out = y + g * M + c;
#pragma unroll
        for (int d = 0; d < kS; ++d) {
          __stcs(out + kR * d, z[d]);
          pw[d] = fmaf(z[d].x, z[d].x, fmaf(z[d].y, z[d].y, pw[d]));
        }
      }
    }
    __syncthreads();
  }

  // 4. the block's row of partial sums: thread j holds channels
  // j % R + R d; its peers are the threads j' = j mod R, added in order
  float* red = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int d = 0; d < kS; ++d) red[tid * kS + d] = pw[d];
  __syncthreads();
  for (int k = tid; k < M; k += kThreads) {
    const int c = k % kR;
    const int d = k / kR;
    float s = 0.0f;
    for (int j = c; j < kThreads; j += kR) s += red[j * kS + d];
    partial[(long long)blockIdx.x * M + k] = s;
  }
}

template <int M>
constexpr size_t smem_bytes() { return (size_t)(kPhys + M) * sizeof(float2); }

template <int M>
cudaError_t allow() {
  return cudaFuncSetAttribute(pfb_kernel<M>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<M>());
}

template <int M>
cudaError_t blocks_of(int* out) {
  cudaError_t e = allow<M>();
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pfb_kernel<M>,
                                                    kThreads, smem_bytes<M>());
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return e;
}

template <int M>
cudaError_t launch(const float2* x, long long nframes, const float* taps, int L,
                   float2* y, float* partial, int grid, cudaStream_t stream) {
  const cudaError_t e = allow<M>();
  if (e != cudaSuccess) return e;
  pfb_kernel<M><<<grid, kThreads, smem_bytes<M>(), stream>>>(
      x, nframes, taps, L, y, partial);
  return cudaGetLastError();
}

// f(std::integral_constant<int, M>) for the instance of M channels
template <typename F>
cudaError_t by_channels(int M, F f) {
  switch (M) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The grid a launch at M channels fills the card with: the blocks that fit
// an SM at once times the SMs, into *blocks.  Returns the cudaError_t (0 on
// success); cudaErrorInvalidValue for M not a power of two in 16..1024.
extern "C" int rr_pfb_blocks(int M, int* blocks) {
  *blocks = 0;
  return (int)by_channels(
      M, [&](auto m) { return blocks_of<decltype(m)::value>(blocks); });
}

// x: complex64 (float2) samples, frame i reading x[i*M - m] for m < M (so
// at least (nframes - 1) * M + 1 of them); taps: L rows of M f32, h[l*M + m];
// y: (nframes, M) complex64; partial: (grid, M) f32,
// each block's sums of |y[i, k]|^2.  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for M not a power of two in
// 16..1024, L outside 1..16, nframes < 1 or grid < 1.
extern "C" int rr_pfb_channelize(const void* x, long long nframes, int M,
                                 const void* taps, int L, void* y,
                                 void* partial, int grid, void* stream) {
  if (L < 1 || L > kMaxL || nframes < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return (int)by_channels(M, [&](auto m) {
    return launch<decltype(m)::value>(
        (const float2*)x, nframes, (const float*)taps, L, (float2*)y,
        (float*)partial, grid, (cudaStream_t)stream);
  });
}
