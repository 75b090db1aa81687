// Kernel G: the reference's IIR filter (src/iir_filter.rs:84-101),
//
//   y[n] = taps[0] * x[n] + sum_{i >= 1} taps[i] * y[n - i]
//
// from a history of the last p = order outputs (most recent first).  It
// has no Pallas counterpart: it replaces the lax.scan of iir_filter
// (rustradio_tpu/ops/iir.py:68).
//
// What bounds it on an H100: bytes.  The function reads 4 bytes and writes
// 4 bytes a sample and does 2p + 1 operations on them, far under the f32
// peak; at 2^24 samples the bytes take 0.040 ms at 3.35 TB/s.  Walked one
// sample after another, the recurrence is instead a chain of dependent
// operations on one lane, some 2000 times longer.
//
// What the design does about it: the recurrence is linear, so the stream
// is cut into chunks of kChunk samples that all walk at once, one thread a
// chunk, over every SM.  With the state s = (y[n-1], ..., y[n-p]) and A
// the filter's companion matrix, a chunk maps the state before it to the
// state after it as s -> M s + g, M = A^kChunk, g the chunk's end state
// from a zero start.  Three launches on the caller's stream:
//
//   1. iir_ends: each block copies kBlock chunks of x into shared memory
//      (16-byte cp.async copies, coalesced, all in flight at once; the
//      granules of a chunk swizzled so that 32 threads walking 32 chunks
//      read four samples each from 32 bank groups), each thread walks its
//      chunk from a zero state (chunk 0 from the caller's history) and
//      keeps g_k; the block then scans its g's (Hillis-Steele in shared
//      memory, level j adding M^(2^j) U[k - 2^j] where k - 2^j lies in the
//      block) into U, the end states of its chunks counted from the block's
//      start, and writes them out.
//   2. iir_carries (one block; only when there is more than one block): the
//      same scan over the blocks' last U's with M^kBlock, a tile of kBlock
//      at a time, each tile's carry applied as (M^kBlock)^(i + 1) by the
//      binary powers of i + 1, lowest bit first: C_b, the state before
//      block b.
//   3. iir_walk: each thread takes its chunk's starting state (the history;
//      U[k - 1]; C_b; or U[k - 1] + M^i C_b, M^i again by binary powers),
//      walks its chunk again from it, and the block writes y out through
//      shared memory, coalesced.
//
// The powers M^(2^j), j < kLevels, come from the host in f32 (computed in
// float64; ops/kernels.py, iir_powers) as a level m_j and a power-of-two
// exponent e_j, M^(2^j) = m_j 2^(e_j): e_j = 0 wherever the power is a
// finite f32 (every stable filter), else the least that makes m_j finite.
// A product m_j v sums its rows, then scales each sum by 2^(e_j) (ldexpf:
// exact, inf only where the true value passes f32's largest), so a zero
// state stays zero and a tiny one stays finite wherever the true product
// is, where an overflowed f32 power would give inf * 0 = NaN.  The
// scaling sits on the carries' serial chain, so it is compiled apart: a
// filter whose exponents are all 0 runs the kernels without it (the
// arithmetic and the speed of the powers in plain f32), and any other the
// general form (O = 0 below) with it.  Each block copies the levels it
// uses into shared memory; the exponents come in the kernels' arguments.
// Every sum adds only terms that
// exist: no power multiplies a pad.  No block waits on another, nothing
// is read back to the host, and a call with one chunk is one launch, with
// one block two.
//
// Numerics: every f32 operation is rounded on its own (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract a*b+c into an FMA.  A walk's
// step sums taps[0] * x[n], then the older terms from taps[p] * y[n - p]
// down to taps[2] * y[n - 2], then taps[1] * y[n - 1] last; a matrix row
// sums its products from column 0 up.  Chunk 0 is the sequential form
// itself.  The plain PyTorch version (ops/kernels.py, iir_scan_plain) does
// the same operations in the same order, and the two agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxOrder = 32;
constexpr int kChunk = 128;            // samples a chunk (a multiple of 32)
constexpr int kBlock = 128;            // chunks (threads) a block
constexpr int kLogBlock = 7;
constexpr int kLevels = 2 * kLogBlock + 1;  // M^(2^j), j < kLevels
constexpr int kTile = kBlock * kChunk;      // a block's samples
// past this exponent every nonzero f32 times 2^e is inf (2^-149 2^278)
constexpr int kExpCap = 300;

static_assert(kBlock == 1 << kLogBlock, "kBlock is a power of two");
static_assert(kChunk % 32 == 0, "a chunk is whole 128-byte lines");
static_assert(kMaxOrder * kBlock <= kTile, "the scan fits the tile");

struct Taps {
  float t[kMaxOrder + 1];
  int order;
  int shift[kLevels];  // M^(2^j) = powers[j] * 2^shift[j]
};

// a product's row sum times 2^e, e >= 0 (S: the filter has an e > 0)
template <bool S>
__device__ __forceinline__ float scaled(float acc, int e) {
  if constexpr (!S) return acc;
  return e == 0 ? acc : ldexpf(acc, min(e, kExpCap));
}

// A chunk's samples lie in its own kChunk words of the tile as 16-byte
// granules, granule g of chunk c at slot g ^ (c % 8): the 32 threads of a
// warp, walking 32 chunks, read their next four samples (one granule each)
// from 32 different bank groups, and a warp's copy of one chunk's
// granules writes them all.
__device__ __forceinline__ int slot(int c, int g) {
  return c * kChunk + ((g ^ (c & 7)) << 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// O > 0: an order-O filter; O == 0: any order up to kMaxOrder, the terms
// past the filter's order predicated off.  S: products scaled by their
// powers' exponents.
template <int O, bool S>
struct Iir {
  static constexpr int kH = O > 0 ? O : kMaxOrder;

  static __device__ __forceinline__ bool live(int i, int p) {
    return O > 0 || i < p;
  }

  // one step of the recurrence; h: the state, most recent first
  static __device__ __forceinline__ float step(const Taps& k, float (&h)[kH],
                                               float x) {
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

  // thread i's chunk of the tile, four samples a load; with Out, each
  // output written over its sample
  template <bool Out>
  static __device__ __forceinline__ void walk(const Taps& k, float (&h)[kH],
                                              float* tile, int i) {
#pragma unroll 2
    for (int g = 0; g < kChunk / 4; ++g) {
      float4* at = reinterpret_cast<float4*>(tile + slot(i, g));
      float4 v = *at;
      v.x = step(k, h, v.x);
      v.y = step(k, h, v.y);
      v.z = step(k, h, v.z);
      v.w = step(k, h, v.w);
      if (Out) *at = v;
    }
  }

  // w = m v 2^e, m a p x p row-major matrix in shared memory
  static __device__ __forceinline__ void matvec(const float* m, int e, int p,
                                                const float (&v)[kH],
                                                float (&w)[kH]) {
#pragma unroll
    for (int r = 0; r < kH; ++r) {
      if (!live(r, p)) continue;
      float acc = __fmul_rn(m[r * p], v[0]);
#pragma unroll
      for (int c = 1; c < kH; ++c)
        if (live(c, p)) acc = __fadd_rn(acc, __fmul_rn(m[r * p + c], v[c]));
      w[r] = scaled<S>(acc, e);
    }
  }

  // v = pw[nbits - 1]^(bit) ... pw[0]^(bit) v over the bits of e, lowest
  // first; pw: consecutive p x p powers, level j's exponent sh[j]
  static __device__ __forceinline__ void power(const float* pw, const int* sh,
                                               int p, int e, int nbits,
                                               float (&v)[kH]) {
    for (int j = 0; j < nbits; ++j) {
      if (!((e >> j) & 1)) continue;
      float w[kH];
      matvec(pw + j * p * p, sh[j], p, v, w);
#pragma unroll
      for (int r = 0; r < kH; ++r) v[r] = w[r];
    }
  }

  // Hillis-Steele over the block's kBlock vectors u (thread i's), in
  // place; su: p x kBlock floats of shared memory; level j adds
  // pw[j] 2^sh[j] u[i - 2^j] where i >= 2^j
  static __device__ __forceinline__ void scan(float* su, float (&u)[kH],
                                              const float* pw, const int* sh,
                                              int p, int i) {
#pragma unroll
    for (int r = 0; r < kH; ++r)
      if (live(r, p)) su[r * kBlock + i] = u[r];
    __syncthreads();
    for (int j = 0; j < kLogBlock; ++j) {
      const int d = 1 << j;
      float v[kH];
      if (i >= d) {
#pragma unroll
        for (int c = 0; c < kH; ++c) v[c] = live(c, p) ? su[c * kBlock + i - d] : 0.0f;
      }
      __syncthreads();
      if (i >= d) {
        float w[kH];
        matvec(pw + j * p * p, sh[j], p, v, w);
#pragma unroll
        for (int r = 0; r < kH; ++r) {
          if (!live(r, p)) continue;
          u[r] = __fadd_rn(u[r], w[r]);
          su[r * kBlock + i] = u[r];
        }
      }
      __syncthreads();
    }
  }
};

// Starts the copy of the block's kTile samples of x into the tile (zeros
// past n) without waiting for it: 16-byte cp.async copies where the block
// is whole and x 16-byte aligned (a warp copies one chunk, coalesced),
// else 4-byte copies, zero-filled past n.  cp_wait() waits for them.
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ x,
                                      long long n, long long base) {
  const int tid = threadIdx.x;
  if (base + kTile <= n && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    for (int q = tid; q < kTile / 4; q += kBlock)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(tile + slot(q / (kChunk / 4), q % (kChunk / 4)))),
                   "l"(x + base + 4 * q));
  } else {
    for (int e = tid; e < kTile; e += kBlock) {
      const bool in = base + e < n;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(tile + slot(e / kChunk, e % kChunk / 4) + e % 4)),
                   "l"(in ? x + base + e : x), "r"(in ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile's outputs to y, up to n, through 16-byte stores where y allows.
__device__ __forceinline__ void flush(const float* tile, float* __restrict__ y,
                                      long long n, long long base) {
  const int tid = threadIdx.x;
  if (base + kTile <= n && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    float4* y4 = reinterpret_cast<float4*>(y + base);
    for (int q = tid; q < kTile / 4; q += kBlock)
      y4[q] = *reinterpret_cast<const float4*>(
          tile + slot(q / (kChunk / 4), q % (kChunk / 4)));
  } else {
    for (int e = tid; e < kTile && base + e < n; e += kBlock)
      y[base + e] = tile[slot(e / kChunk, e % kChunk / 4) + e % 4];
  }
}

// count floats of device memory into shared memory
__device__ __forceinline__ void load(float* dst, const float* __restrict__ src,
                                     int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) dst[j] = src[j];
}

// Pass 1.  u: p x (blocks * kBlock) floats, u[r * stride + k].  Shared
// memory: the tile, then M^(2^j), j < kLogBlock.
template <int O, bool S>
__global__ void __launch_bounds__(kBlock) iir_ends(
    const float* __restrict__ x, long long n, Taps k,
    const float* __restrict__ hist, const float* __restrict__ pw,
    float* __restrict__ u, long long stride) {
  using G = Iir<O, S>;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* spw = smem + kTile;
  const int i = threadIdx.x, p = O > 0 ? O : k.order;
  const long long chunk = (long long)blockIdx.x * kBlock + i;
  stage(tile, x, n, (long long)blockIdx.x * kTile);
  load(spw, pw, kLogBlock * p * p);
  float h[G::kH];
#pragma unroll
  for (int r = 0; r < G::kH; ++r) h[r] = chunk == 0 && G::live(r, p) ? hist[r] : 0.0f;
  cp_wait();
  __syncthreads();
  G::template walk<false>(k, h, tile, i);
  __syncthreads();  // the tile's words become the scan's
  G::scan(tile, h, spw, k.shift, p, i);
#pragma unroll
  for (int r = 0; r < G::kH; ++r)
    if (G::live(r, p)) u[r * stride + chunk] = h[r];
}

// Pass 2.  c: p x blocks floats, c[r * blocks + b] the state before block
// b (b >= 1); the blocks' last ends are u[r * stride + b * kBlock + kBlock
// - 1].  Shared memory: the scan's p x kBlock, then M^(kBlock 2^j), j <=
// kLogBlock.
template <int O, bool S>
__global__ void __launch_bounds__(kBlock) iir_carries(
    Taps k, const float* __restrict__ pw, const float* __restrict__ u,
    long long stride, long long blocks, float* __restrict__ c) {
  using G = Iir<O, S>;
  extern __shared__ __align__(16) float smem[];
  const int i = threadIdx.x, p = O > 0 ? O : k.order;
  float* su = smem;
  float* spw = smem + p * kBlock;
  load(spw, pw + kLogBlock * p * p, (kLogBlock + 1) * p * p);
  float carry[G::kH];
  for (long long t0 = 0; t0 < blocks - 1; t0 += kBlock) {
    const long long q = t0 + i;
    const bool real = q < blocks - 1;
    float v[G::kH];
#pragma unroll
    for (int r = 0; r < G::kH; ++r)
      v[r] = real && G::live(r, p) ? u[r * stride + q * kBlock + kBlock - 1] : 0.0f;
    // the scan's first barrier also covers the load
    G::scan(su, v, spw, k.shift + kLogBlock, p, i);
    if (t0 > 0) {
      float w[G::kH];
#pragma unroll
      for (int r = 0; r < G::kH; ++r) w[r] = carry[r];
      G::power(spw, k.shift + kLogBlock, p, i + 1, kLogBlock + 1, w);
#pragma unroll
      for (int r = 0; r < G::kH; ++r)
        if (G::live(r, p)) v[r] = __fadd_rn(v[r], w[r]);
    }
    if (real) {
#pragma unroll
      for (int r = 0; r < G::kH; ++r)
        if (G::live(r, p)) c[r * blocks + q + 1] = v[r];
    }
    if (i == kBlock - 1) {
#pragma unroll
      for (int r = 0; r < G::kH; ++r)
        if (G::live(r, p)) su[r * kBlock + i] = v[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < G::kH; ++r)
      carry[r] = G::live(r, p) ? su[r * kBlock + kBlock - 1] : 0.0f;
    __syncthreads();
  }
}

// Pass 3.  Shared memory as pass 1's.
template <int O, bool S>
__global__ void __launch_bounds__(kBlock) iir_walk(
    const float* __restrict__ x, long long n, Taps k,
    const float* __restrict__ hist, const float* __restrict__ pw,
    const float* __restrict__ u, long long stride, long long blocks,
    const float* __restrict__ c, float* __restrict__ y) {
  using G = Iir<O, S>;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* spw = smem + kTile;
  const int i = threadIdx.x, p = O > 0 ? O : k.order;
  const long long b = blockIdx.x, chunk = b * kBlock + i;
  const long long base = b * kTile;
  stage(tile, x, n, base);
  float h[G::kH];
  if (chunk == 0) {
#pragma unroll
    for (int r = 0; r < G::kH; ++r) h[r] = G::live(r, p) ? hist[r] : 0.0f;
  } else if (b == 0) {
#pragma unroll
    for (int r = 0; r < G::kH; ++r) h[r] = G::live(r, p) ? u[r * stride + chunk - 1] : 0.0f;
  } else {
    load(spw, pw, kLogBlock * p * p);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < G::kH; ++r) h[r] = G::live(r, p) ? c[r * blocks + b] : 0.0f;
    if (i > 0) {
      G::power(spw, k.shift, p, i, kLogBlock, h);
#pragma unroll
      for (int r = 0; r < G::kH; ++r)
        if (G::live(r, p)) h[r] = __fadd_rn(u[r * stride + chunk - 1], h[r]);
    }
  }
  cp_wait();
  __syncthreads();
  G::template walk<true>(k, h, tile, i);
  __syncthreads();
  flush(tile, y, n, base);
}

// shared memory of passes 1 and 3, and of pass 2
size_t tile_bytes(int p) {
  return sizeof(float) * (kTile + kLogBlock * p * p);
}
size_t carry_bytes(int p) {
  return sizeof(float) * (p * kBlock + (kLogBlock + 1) * p * p);
}

template <typename K>
cudaError_t allow(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <int O, bool S>
cudaError_t launch(cudaStream_t s, const float* x, long long n, const Taps& k,
                   const float* hist, const float* pw, float* scratch,
                   float* y) {
  // the attribute once per kernel, at the most its orders need
  static bool ends_ok = false, walk_ok = false, carries_ok = false;
  const int most = O > 0 ? O : kMaxOrder;
  cudaError_t e = allow(iir_ends<O, S>, tile_bytes(most), &ends_ok);
  if (e == cudaSuccess) e = allow(iir_walk<O, S>, tile_bytes(most), &walk_ok);
  if (e == cudaSuccess)
    e = allow(iir_carries<O, S>, carry_bytes(most), &carries_ok);
  if (e != cudaSuccess) return e;
  const int p = k.order;
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's limit
  const long long stride = blocks * kBlock;
  float* u = scratch;
  float* c = scratch + (size_t)p * stride;
  if (chunks > 1) {
    iir_ends<O, S><<<(unsigned)blocks, kBlock, tile_bytes(p), s>>>(
        x, n, k, hist, pw, u, stride);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (blocks > 1) {
    iir_carries<O, S><<<1, kBlock, carry_bytes(p), s>>>(k, pw, u, stride,
                                                            blocks, c);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  iir_walk<O, S><<<(unsigned)blocks, kBlock, tile_bytes(p), s>>>(
      x, n, k, hist, pw, u, stride, blocks, c, y);
  return cudaGetLastError();
}

}  // namespace

// The layout the wrapper mirrors (ops/kernels.py): {kChunk, kBlock,
// kLevels}.
extern "C" void rr_iir_layout(int* out) {
  out[0] = kChunk;
  out[1] = kBlock;
  out[2] = kLevels;
}

// x: n f32; taps: ntaps host floats (order p = ntaps - 1, 1..32); shifts:
// kLevels host ints, the powers' exponents (>= 0); hist: p f32 on the
// device, the last outputs before x[0], most recent first; powers: kLevels
// p x p f32 on the device, M^(2^j) = powers[j] * 2^shifts[j] row-major, M =
// A^kChunk; scratch: p * blocks * (kBlock + 1) f32 on the device, blocks
// = ceil(ceil(n / kChunk) / kBlock); y: n f32.  Returns the cudaError_t of
// the launches (0 on success); cudaErrorInvalidValue for an order outside
// 1..32, a negative exponent or n past 2^31 blocks.  n == 0 launches nothing.
extern "C" int rr_iir_filter(const void* x, long long n, const float* taps,
                             int ntaps, const int* shifts, const void* hist,
                             const void* powers, void* scratch, void* y,
                             void* stream) {
  const int order = ntaps - 1;
  if (order < 1 || order > kMaxOrder || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Taps k;
  for (int i = 0; i <= kMaxOrder; ++i) k.t[i] = i < ntaps ? taps[i] : 0.0f;
  k.order = order;
  bool scale = false;
  for (int j = 0; j < kLevels; ++j) {
    if (shifts[j] < 0) return (int)cudaErrorInvalidValue;
    k.shift[j] = shifts[j];
    scale = scale || shifts[j] > 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xs = (const float*)x;
  const float* h = (const float*)hist;
  const float* pw = (const float*)powers;
  float* sc = (float*)scratch;
  float* ys = (float*)y;
  if (scale) return (int)launch<0, true>(s, xs, n, k, h, pw, sc, ys);
  switch (order) {
    case 1: return (int)launch<1, false>(s, xs, n, k, h, pw, sc, ys);
    case 2: return (int)launch<2, false>(s, xs, n, k, h, pw, sc, ys);
    case 3: return (int)launch<3, false>(s, xs, n, k, h, pw, sc, ys);
    case 4: return (int)launch<4, false>(s, xs, n, k, h, pw, sc, ys);
    case 5: return (int)launch<5, false>(s, xs, n, k, h, pw, sc, ys);
    case 6: return (int)launch<6, false>(s, xs, n, k, h, pw, sc, ys);
    case 7: return (int)launch<7, false>(s, xs, n, k, h, pw, sc, ys);
    case 8: return (int)launch<8, false>(s, xs, n, k, h, pw, sc, ys);
    default: return (int)launch<0, false>(s, xs, n, k, h, pw, sc, ys);
  }
}
