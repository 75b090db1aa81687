// The FIR core of kernels A (fir_decimate.cu) and B (fm_chain.cu): one
// register-blocked decimating dot product
//     z[o] = sum_k trev[k] * X(p0 + o*deci + k),   k in [0, ntaps),
// over a tile of outputs per block, X(p) the plane value (or `pad` outside
// the plane), accumulated with f32 fmaf in a fixed tap order.
//
// What bounds a FIR on an H100.  One output per thread with taps and
// samples in shared memory costs two shared loads per FMA; an SM issues
// one 32-lane shared load a cycle against four 32-lane FMAs, so such a
// kernel runs at an eighth of the FMA rate whatever its length (1205 taps
// over 2^22 samples: 316 M warp-loads = 1.36 ms, against a 0.151 ms FMA
// bound), and a short filter (49 taps at deci 4) that should run at the
// device-memory rate is held by the same loads and by a scalar staging
// pass.
//
// What the design does about it:
//   * each thread computes R consecutive outputs (R = 4 or 8) from a
//     sliding window held in registers: one step along the taps loads ONE
//     new sample per plane and one tap, and issues R FMAs per plane, so
//     shared loads fall from 2 per FMA to about (1 + 1/4) / R: the FMA
//     pipe becomes the limit of a long filter, and the dot product stops
//     being the limit of a short one.  The tap loop is unrolled by R, so the window rotates through
//     compile-time register names and never goes to local memory; the
//     taps of a group come as float4 loads; a phase's last taps (fewer
//     than R) run as an unrolled tail of predicated steps, so no tap or
//     sample beyond the filter is ever multiplied in.
//   * a decimating filter is run phase by phase: phase p holds the samples
//     X(p0 + c*deci + p) (column c) and the taps trev[q*deci + p], and is
//     a stride-1 FIR over columns, so the same sliding window serves every
//     deci.  The accumulation order of an output is fixed: phases
//     ascending, taps ascending inside a phase.  Only the min(deci, ntaps)
//     phases that hold a tap are kept in shared memory.
//   * thread t reads columns t*R + j, a stride of R words across a warp:
//     an R-way bank conflict in a plain row.  Rows therefore carry one
//     unused word after every R columns (column c lives at word c + c/R),
//     which makes the lane stride R + 1, odd, so a warp's 32 loads hit 32
//     banks, and keeps every offset inside an unrolled group a
//     compile-time immediate (no address arithmetic per load).
//   * the span of a tile is read from device memory as 16-byte vectors
//     (4 f32, 8 bf16, 16 s8) on the plane's own 16-byte grid, starting at
//     or below the tile's first sample; vectors that cross the plane's
//     ends fall back to guarded scalar loads, so positions outside the
//     plane are masked to `pad` and never read.  deci is a run-time
//     integer: the phase and column of a staged sample come from one
//     division per thread and carries after it, never a division per
//     sample; for deci 1, 2 and 4 the staging is also compiled with deci
//     known, which turns the scatter of a whole vector into stores at
//     compile-time slots (kernel B, 49 taps at deci 4 over 2^24 bf16
//     samples: 0.062 ms against 0.081 ms through the general path; kernel
//     A, 65 taps at deci 1 over 14.3 M samples: 0.068 against 0.085 ms; an
//     H100 at 700 W, tools/time_fir.py run from both builds in turns).
//   * tiles start at multiples of the tile size; the launcher shrinks the
//     tile (threads and R, then the tile itself) until the rows fit the
//     227 KB a block may use, and takes smaller tiles when the outputs
//     would otherwise fill fewer blocks than two per SM.
// What is left (H100, 49 taps at deci 4): skeleton, staging, dot product
// and discriminator each take their time one after the other, and an SM
// holds 5 blocks of 5 warps (shared memory and registers both at their
// limit), too few to overlap them; the short filters run at 25-50% of the
// memory rate.  A scatter of half the instructions and cp.async copies of
// the next tile during the dot product were measured and changed nothing.
// Accumulation is f32 fmaf on the taps it is given: no TF32, no tensor
// cores.  A banded tensor-core form of a 1205-tap filter in true f32
// (3xTF32 or 6 bf16 passes over a band that is 82% useful at 256 outputs
// a row) comes to about 75 us at the card's peak, at best 2x under the
// FMA bound of this form and far more code; it is not taken here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rr {
namespace fir {

constexpr size_t kMaxSmem = 227 * 1024;
constexpr long long kWantBlocks = 2 * 132;  // two blocks per SM of an H100

// Word of column c in a padded row.
template <int R>
__host__ __device__ constexpr int padcol(int c) {
  return c + c / R;
}

// Geometry of one tile, computed on the host and passed by value.
struct Tile {
  int deci, ntaps;
  int nphase;    // phases that hold a tap, min(deci, ntaps)
  int nq0;       // taps of phase 0, ceil(ntaps / deci)
  int r0;        // phases p < r0 hold nq0 taps, the others nq0 - 1
  int tstride;   // words per phase of taps, nq0 rounded up to 4
  int tile;      // outputs per block, a multiple of R
  int lead;      // columns staged before the tile's first output
  int span_len;  // samples staged per plane
  int row_len;   // words per phase row
};

template <int R>
inline Tile make_tile(int tile, int lead, int ntaps, int deci) {
  Tile g;
  g.deci = deci;
  g.ntaps = ntaps;
  g.nphase = deci < ntaps ? deci : ntaps;
  g.nq0 = (ntaps + deci - 1) / deci;
  g.r0 = ntaps - (g.nq0 - 1) * deci;
  g.tstride = (g.nq0 + 3) / 4 * 4;
  g.tile = tile;
  g.lead = lead;
  g.span_len = (tile - 1 + lead) * deci + ntaps;  // shape_smem() bounds it
  g.row_len = padcol<R>(lead + tile + g.nq0) + 1;
  return g;
}

// Shared-memory words of the taps and of `planes` staged planes.
inline long long smem_words(const Tile& g, int planes) {
  return (long long)g.nphase * g.tstride + (long long)planes * g.nphase * g.row_len;
}

// One launch shape: R, threads that compute, outputs per block.
struct Shape {
  int r, threads, tile;
};

// Shared-memory bytes of a shape, or 0 when it does not fit a block.
// `extra` words per computing thread and `fixed` words come on top of
// the taps and rows.
inline size_t shape_smem(const Shape& s, int ntaps, int deci, int planes, int lead,
                         int extra, int fixed) {
  if ((long long)(s.tile + lead) * deci + ntaps > 0x3fffffff) return 0;
  const Tile g = s.r == 8 ? make_tile<8>(s.tile, lead, ntaps, deci)
                          : make_tile<4>(s.tile, lead, ntaps, deci);
  const long long words = smem_words(g, planes) + (long long)extra * s.threads + fixed;
  const long long bytes = words * (long long)sizeof(float);
  return bytes > (long long)kMaxSmem ? 0 : (size_t)bytes;
}

// The largest shape whose shared memory fits and that still fills the
// card: the first of the list where the outputs make two blocks per SM,
// else the smallest tile of 128 or more; below that the tile alone
// shrinks, only until it fits (a large deci with few taps).  Returns false
// when nothing fits.
inline bool pick_shape(int ntaps, int deci, long long outputs, int planes, int lead,
                       int extra, int fixed, Shape* out, size_t* smem) {
  static const Shape shapes[] = {{8, 128, 1024}, {4, 128, 512}, {4, 64, 256},
                                 {4, 32, 128},   {4, 32, 64},   {4, 32, 32},
                                 {4, 32, 16},    {4, 32, 8},    {4, 32, 4}};
  bool found = false;
  for (const Shape& s : shapes) {
    if (found && s.tile < 128) break;
    const size_t bytes = shape_smem(s, ntaps, deci, planes, lead, extra, fixed);
    if (bytes == 0) continue;
    found = true;
    *out = s;
    *smem = bytes;
    if ((outputs + s.tile - 1) / s.tile >= kWantBlocks) break;
  }
  return found;
}

// Before a kernel's first launch, ask for the whole of the SM's
// configurable memory as shared memory (these kernels read every global
// byte once, so L1 buys nothing and resident blocks everything); then
// raise its dynamic shared-memory limit once per size reached.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem, size_t* allowed) {
  if (*allowed == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    *allowed = 48 * 1024;
  }
  if (smem <= *allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

// ---- device side

// A 16-byte vector of plane values as f32.
template <typename T>
struct Plane;
template <>
struct Plane<float> {
  static __device__ __forceinline__ float one(float v) { return v; }
  static __device__ __forceinline__ void vec(const uint4& raw, float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Plane<__nv_bfloat16> {
  static __device__ __forceinline__ float one(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void vec(const uint4& raw, float (&v)[8]) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);  // a bf16 is the high half of an f32
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};
template <>
struct Plane<int8_t> {
  static __device__ __forceinline__ float one(int8_t v) { return (float)v; }
  static __device__ __forceinline__ void vec(const uint4& raw, float (&v)[16]) {
    // byte b + 128 as the low mantissa byte of 2^23: a permute and a
    // subtraction per sample, no integer-to-float conversion
    const unsigned w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                           raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[4 * k + b] =
            __uint_as_float(__byte_perm(w[k], 0x4B000000u, 0x7440 + b)) - 8388736.0f;
      }
    }
  }
};

// f32 planes read as the bf16 or s8 plane that the host's cast would make
// of them (torch's x.to(bfloat16); to_s8: clamp(round(x * 128), -127,
// 128) - 1), each value rounded in registers as it is loaded: the kernel
// sees the same plane values as on the cast planes, without the cast's
// pass over device memory.  The storage is one f32, so a vector holds 4.
struct F32AsBf16 {
  float v;
  // round to nearest even, as torch's cast does for every value but NaN
  static __device__ __forceinline__ float value(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
struct F32AsS8 {
  float v;
  // rintf rounds half to even, as torch.round; the s8 value u8 - 128
  static __device__ __forceinline__ float value(float x) {
    return fminf(fmaxf(rintf(x * 128.0f), -127.0f), 128.0f) - 1.0f;
  }
};
template <typename S>
struct RoundedPlane {
  static __device__ __forceinline__ float one(S x) { return S::value(x.v); }
  static __device__ __forceinline__ void vec(const uint4& raw, float (&v)[4]) {
    v[0] = S::value(__uint_as_float(raw.x));
    v[1] = S::value(__uint_as_float(raw.y));
    v[2] = S::value(__uint_as_float(raw.z));
    v[3] = S::value(__uint_as_float(raw.w));
  }
};
template <>
struct Plane<F32AsBf16> : RoundedPlane<F32AsBf16> {};
template <>
struct Plane<F32AsS8> : RoundedPlane<F32AsS8> {};

// Taps into shared memory, phase-major: hp[p * tstride + q] = trev[q*deci + p].
// D is deci where it is known when compiling, else 0 (as for Stager).
template <int D>
__device__ __forceinline__ void stage_taps(float* __restrict__ hp,
                                           const float* __restrict__ trev,
                                           const Tile& g, int tid, int nthreads) {
  const int deci = D > 0 ? D : g.deci;
  for (int k = tid; k < g.ntaps; k += nthreads) {
    hp[(k % deci) * g.tstride + k / deci] = trev[k];
  }
}

// Stages samples [p0, p0 + span_len) of one plane (L values; `pad`
// outside) into its phase rows: sample p0 + i goes to row i % deci, column
// i / deci.  A thread's vectors are v = v0 + u * nthreads, u < kLoads, per
// round; load() requests a round's vectors and scatter() converts and
// stores them, so a caller with several planes requests all of them
// before it uses the first.  Two vectors per plane and round: more in
// flight cost registers, and with them resident blocks, which hide the
// memory's latency better than a thread's own loads do (4 per round ran
// kernel B a third slower on an H100).
// D is deci where it is known when compiling (1, 2 or 4, dividing the
// vector length, and no more than ntaps), else 0.  With D known, the
// phase of a vector's k-th sample is (r + k) % D for a block-wide constant
// r, so a whole vector inside the plane and the span is scattered through
// D row pointers and a carry bit per phase slot, all indexed at compile
// time: a conversion, a select, an add and a store per sample.  Vectors
// at the ends of the plane or the span, and every vector when D is 0,
// take the general path: guarded scalar loads and a carried (phase,
// column) pair.
constexpr int kLoads = 2;

template <typename T, int R, int D>
struct Stager {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int DD = D > 0 ? D : 1;
  static_assert(V % DD == 0, "a vector holds whole columns");

  float* rows;
  const Tile& g;
  const T* plane;
  long long L, e0;
  float pad;
  int nthreads, head, nvec;
  int deci;          // D where known: divisions by it compile to shifts
  int p, c, dp, dc;  // phase and column of the next vector's first sample
  float* slot[DD];   // D known: slot j of a column group goes to row
  bool wraps[DD];    // (p + j) % D, one column on where p + j wraps

  __device__ __forceinline__ Stager(float* rows_, const Tile& g_, const T* plane_,
                                    long long L_, long long p0, float pad_, int tid,
                                    int nthreads_)
      : rows(rows_), g(g_), plane(plane_), L(L_), pad(pad_), nthreads(nthreads_) {
    // plane + e is 16-byte aligned where (e + mis) % V == 0
    const int mis = (int)((reinterpret_cast<uintptr_t>(plane) / sizeof(T)) % V);
    head = (int)((p0 + mis) % V);  // samples of the first vector before p0
    if (head < 0) head += V;
    e0 = p0 - head;
    nvec = (head + g.span_len + V - 1) / V;
    deci = D > 0 ? D : g.deci;
    // from an origin moved back by whole columns, so that the first
    // vector's phase and column are not negative
    const int back = (head + deci - 1) / deci;
    const int start = tid * V - head + back * deci;
    p = start % deci;
    c = start / deci - back;
    const int step = nthreads * V;
    dp = step % deci;
    dc = step / deci;
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      wraps[j] = p + j >= DD;
      slot[j] = rows + (wraps[j] ? p + j - DD : p + j) * g.row_len;
    }
  }

  __device__ __forceinline__ void load(int v0, uint4 (&raw)[kLoads],
                                       bool (&whole)[kLoads]) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = v0 + u * nthreads;
      const long long e = e0 + (long long)v * V;
      whole[u] = v < nvec && e >= 0 && e + V <= L;
      if (whole[u]) raw[u] = *reinterpret_cast<const uint4*>(plane + e);
    }
  }

  __device__ __forceinline__ void scatter(int v0, const uint4 (&raw)[kLoads],
                                          const bool (&whole)[kLoads]) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = v0 + u * nthreads;
      if (v < nvec) {
        const int i = v * V - head;
        float val[V];
        if (whole[u]) {
          Plane<T>::vec(raw[u], val);
        } else {
          const long long e = e0 + (long long)v * V;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const long long ek = e + k;
            val[k] = (ek >= 0 && ek < L) ? Plane<T>::one(plane[ek]) : pad;
          }
        }
        if (D > 0 && whole[u] && i >= 0 && i + V <= g.span_len) {
          int word[V / DD + 1];
#pragma unroll
          for (int d = 0; d <= V / DD; ++d) word[d] = padcol<R>(c + d);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            slot[k % DD][wraps[k % DD] ? word[k / DD + 1] : word[k / DD]] = val[k];
          }
        } else {
          int pk = p, ck = c;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (i + k >= 0 && i + k < g.span_len && pk < g.nphase) {
              rows[pk * g.row_len + padcol<R>(ck)] = val[k];
            }
            if (++pk == deci) {
              pk = 0;
              ++ck;
            }
          }
        }
      }
      p += dp;
      c += dc;
      if (p >= deci) {
        p -= deci;
        ++c;
      }
    }
  }
};

// NP planes of L values each (`planes[n]` into rows + n * plane_stride),
// all from the same p0: every plane's vectors of a round are requested
// before the first is scattered.
template <typename T, int R, int D, int NP>
__device__ __forceinline__ void stage_span(float* __restrict__ rows, int plane_stride,
                                           const Tile& g, const T* const (&planes)[NP],
                                           long long L, long long p0, float pad,
                                           int tid, int nthreads) {
  using S = Stager<T, R, D>;
  if (NP == 1) {
    S a(rows, g, planes[0], L, p0, pad, tid, nthreads);
    for (int v0 = tid; v0 < a.nvec; v0 += kLoads * nthreads) {
      uint4 raw[kLoads];
      bool whole[kLoads];
      a.load(v0, raw, whole);
      a.scatter(v0, raw, whole);
    }
  } else {
    static_assert(NP <= 2, "one or two planes");
    S a(rows, g, planes[0], L, p0, pad, tid, nthreads);
    S b(rows + plane_stride, g, planes[NP - 1], L, p0, pad, tid, nthreads);
    const int nvec = a.nvec > b.nvec ? a.nvec : b.nvec;
    for (int v0 = tid; v0 < nvec; v0 += kLoads * nthreads) {
      uint4 raw_a[kLoads], raw_b[kLoads];
      bool whole_a[kLoads], whole_b[kLoads];
      a.load(v0, raw_a, whole_a);
      b.load(v0, raw_b, whole_b);
      a.scatter(v0, raw_a, whole_a);
      b.scatter(v0, raw_b, whole_b);
    }
  }
}

// The deci to compile in for a launch: 1, 2 or 4 where every phase holds
// a tap and the shape is the wide one, else 0 (the general staging path).
inline int fixed_deci(const Shape& s, int ntaps, int deci) {
  return s.r == 8 && ntaps >= deci && (deci == 1 || deci == 2 || deci == 4) ? deci : 0;
}

// One step along the taps: bring the window's newest sample in (column
// `col` past x, per plane) and add tap h times the window to the R sums.
// U is the step's place in its group of R, so every register index is a
// compile-time constant.
template <int R, int NP, int LEAD, int U>
__device__ __forceinline__ void fir_step(const float* __restrict__ x, int plane_stride,
                                         float h, float (&w)[NP][R],
                                         float (&acc)[NP][R]) {
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) {
    w[pl][(U + R - 1) % R] = x[pl * plane_stride + padcol<R>(LEAD + U + R - 1)];
  }
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[pl][r] = fmaf(h, w[pl][(U + r) % R], acc[pl][r]);
    }
  }
}

template <int R, int NP, int LEAD, int U>
struct Steps {
  // a whole group: taps hv[0..R)
  static __device__ __forceinline__ void group(const float* __restrict__ x, int ps,
                                               const float (&hv)[R], float (&w)[NP][R],
                                               float (&acc)[NP][R]) {
    fir_step<R, NP, LEAD, U>(x, ps, hv[U], w, acc);
    Steps<R, NP, LEAD, U + 1>::group(x, ps, hv, w, acc);
  }
  // the last `left` < R taps of a phase
  static __device__ __forceinline__ void tail(const float* __restrict__ x, int ps,
                                              const float* __restrict__ h, int left,
                                              float (&w)[NP][R], float (&acc)[NP][R]) {
    if (U < left) {
      fir_step<R, NP, LEAD, U>(x, ps, h[U], w, acc);
      Steps<R, NP, LEAD, U + 1>::tail(x, ps, h, left, w, acc);
    }
  }
};
template <int R, int NP, int LEAD>
struct Steps<R, NP, LEAD, R> {
  static __device__ __forceinline__ void group(const float*, int, const float (&)[R],
                                               float (&)[NP][R], float (&)[NP][R]) {}
  static __device__ __forceinline__ void tail(const float*, int, const float*, int,
                                              float (&)[NP][R], float (&)[NP][R]) {}
};

// acc[pl][r] = z[t*R + r] of plane pl for the block's tile: column LEAD +
// t*R + r + q of phase p times tap q of phase p, phases then taps
// ascending.  `span` holds NP planes of nphase rows, `plane_stride` words
// apart.
template <int R, int NP, int LEAD>
__device__ __forceinline__ void accumulate(const float* __restrict__ span,
                                           int plane_stride, const Tile& g,
                                           const float* __restrict__ hp, int t,
                                           float (&acc)[NP][R]) {
  static_assert(R % 4 == 0, "taps are read as float4");
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[pl][r] = 0.0f;
  }
  const float* home = span + t * (R + 1);  // word of column t*R
  for (int p = 0; p < g.nphase; ++p) {
    const int nq = g.nq0 - (p >= g.r0 ? 1 : 0);
    const float* h = hp + p * g.tstride;
    const float* x = home + p * g.row_len;
    float w[NP][R];
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
      for (int r = 0; r < R - 1; ++r) {
        w[pl][r] = x[pl * plane_stride + padcol<R>(LEAD + r)];
      }
    }
    int q = 0;
    // R columns on are R + 1 words on, whatever LEAD: q stays a multiple of R
    for (; q + R <= nq; q += R, x += R + 1, h += R) {
      float hv[R];
#pragma unroll
      for (int k = 0; k < R; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(h + k);
        hv[k] = v.x;
        hv[k + 1] = v.y;
        hv[k + 2] = v.z;
        hv[k + 3] = v.w;
      }
      Steps<R, NP, LEAD, 0>::group(x, plane_stride, hv, w, acc);
    }
    Steps<R, NP, LEAD, 0>::tail(x, plane_stride, h, nq - q, w, acc);
  }
}

// z of the one output before the tile (column 0 on; needs lead >= 1), by
// one thread, in the order accumulate() sums an output: the same bits as
// the neighbouring tile's last output.
template <int R>
__device__ __forceinline__ float accumulate_one(const float* __restrict__ rows,
                                                const Tile& g,
                                                const float* __restrict__ hp) {
  float acc = 0.0f;
  for (int p = 0; p < g.nphase; ++p) {
    const int nq = g.nq0 - (p >= g.r0 ? 1 : 0);
    const float* h = hp + p * g.tstride;
    const float* x = rows + p * g.row_len;
    for (int q = 0; q < nq; ++q) acc = fmaf(h[q], x[padcol<R>(q)], acc);
  }
  return acc;
}

// R consecutive f32 results to dst[0..R), those at or past `left` dropped.
template <int R>
__device__ __forceinline__ void store_run(float* __restrict__ dst, const float (&v)[R],
                                          long long left) {
  if (left >= R && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < left) dst[k] = v[k];
    }
  }
}

}  // namespace fir
}  // namespace rr
