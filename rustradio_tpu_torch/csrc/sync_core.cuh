// The core of kernels D and E (symbol_sync.cu): the clock recovery's
// constants, its clock filter and timing-error reduction, and the roles of
// a block that walks one channel.
//
// What bounds clock recovery on an H100.  Each sample (kernel E) or crossing
// slot (kernel D) needs the clock and offsets that the one before it left,
// so a channel is one lane walking its stream.  Bytes and operations are
// nowhere near a limit (9 B and two operations a sample).  The least time is
// the longest recurrence of the busiest channel, each f32 operation rounded
// on its own, at the card's latency between dependent operations.  In
// kernel D that is clock to clock over every slot: the reduction's first
// quotient (through the clock's reciprocal), the reduction and the clock
// filter, ~110 cycles at the latencies below; the gap, the other quotients
// and the next middle run beside it.  In kernel E it is the clock filter
// over applied crossings (~58 cycles each); the positions between two step
// backs are sums of 1 that a jump takes in one addition, so they hold
// nothing.  Measured on an H100 at 700 W, a lone lane pays 4.1 cycles for
// a dependent addition, 44.4 for an IEEE division, 19 for a reciprocal
// (MUFU.RCP) or a rounding to a whole number (FRND), ~15 for a compare it
// has to wait for, ~25 for every taken branch, and it issues one
// instruction a cycle at best.  Control flow and every slot's tests, not
// arithmetic, are what a walker with a branch a test pays for (kernel D
// took ~480 cycles a real slot so, four times its chain).  So both walkers
// take their common step as one stretch of code with no branch and redo
// the rare one on a general path: kernel E goes from crossing to crossing,
// each gap one jump, so that its time follows the crossings (~100
// instructions each) and not the samples; kernel D takes four slots at a
// time (~100 instructions and ~220 cycles a slot in the AX.25 cell).  The
// rest of a tile's work goes to the other warps.
//
// What the design does about it: one block of kThreads per channel, with
// roles.
//   * the walker, lane 0 of warp 0, carries the recurrence and touches only
//     registers and shared memory; alone in its warp it pays no divergence;
//   * the loader, warp 1, brings the next tile of the channel's input into
//     shared memory with coalesced loads (a row starts at c*n elements, at
//     any 4-byte residue: a lane loads one element, so nothing is peeled)
//     and reduces it to what the walker needs: for kernel E the list of
//     its crossings (__ballot_sync, then a __popc prefix), for kernel D the
//     slot positions and the tile's first padding slot;
//   * the flushers, warps 2-3, write the walker's results of the previous
//     tile to device memory, coalesced: for kernel E they first place the
//     emissions of the gaps the walker jumped and expand its lists of
//     emitted samples and clock changes into the (C, N) mask bytes and
//     clocks.
// Three tiles are in flight (load t+1, walk t, flush t-1) behind one
// __syncthreads() per tile; the loader and the flushers take a few
// thousand cycles a tile, under the walker's, so neither asynchronous
// copies nor mbarrier pairs would shorten anything.  Channels are
// independent blocks; more channels than the card holds at once queue.
//   * the clock filter is compiled per tap count (1, 2, 6; any count up to
//     16 through the general form), its history in registers;
//   * the timing-error reduction leaves at the first step that changes
//     nothing and carries t - clock into the next step;
//   * x / 2 is __fmul_rn(x, 0.5f): exact, as the division is;
//   * kernel E's walk (ScanWalker: Positions, gap, quiet, straight): between
//     two crossings no sample's step does more than pos + 1 and the
//     emission and step-back tests, so the walker jumps the gap with one
//     addition and finds its emissions by exact compares; a crossing and
//     the gap before it run as one stretch of code (straight) where no step
//     back falls in the gap, the clock is at least 2, the position is in
//     [1, 2^21) and stays under 4 times its binade's top, and the loops
//     need no more than their inline rounds; the other crossings (a few in
//     a hundred) are walked again by the general path, which still jumps
//     from event to event and steps sample by sample only below position 1,
//     at 2^21 or more, or with a NaN middle, and counts those samples;
//   * kernel D takes each channel's count of real slots from the caller
//     where it has one, else the loader finds the first padding slot by a
//     ballot; either way the walker compares no sentinel;
//   * kernel D's walk (EventsWalker: straight, step, tile): the common slot
//     in one stretch with no branch, its quotients' floors from the clock's
//     reciprocal where they are decided (floor_exact), four slots to one
//     branch; a group with another slot is walked again slot by slot, that
//     slot through the general path, the scan's operations as written.
//
// Numerics: every f32 operation is rounded on its own (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn), because nvcc contracts a*b+c into an
// FMA by default and one contraction moves an emission by a sample; each
// value is computed by the operations of the JAX scans
// (rustradio_tpu/ops/symbol_sync.py:87-143, :246-292) and of native
// rr_symbol_sync, in their order, so both kernels equal their plain PyTorch
// versions (ops/kernels.py) bit for bit.  Where kernel D's straight stretch
// takes a floor or a ceiling of a quotient from a reciprocal, or a floor
// by additions, the comment beside it proves the value the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rr {
namespace sync {

constexpr int kMaxTaps = 16;  // clock filter taps; the wrapper raises above
constexpr int kThreads = 128;  // warp 0 walks, warp 1 loads, warps 2-3 flush
constexpr int kFlushers = kThreads - 64;
constexpr int kTile = 1024;  // samples (E) or slots (D) per tile
constexpr int kWords = kTile / 32;

struct Consts {
  float sps, mx, mi08, mx12, lo, hi;
  float taps[kMaxTaps];
  int ntaps;
};

// The constants of both recurrences, in f32 as the JAX package computes
// them; false when the tap count is out of range.
inline bool make_consts(float sps, float max_dev, const float* taps, int ntaps,
                        Consts* k) {
  if (ntaps < 1 || ntaps > kMaxTaps) return false;
  const float mi = sps - max_dev;
  const float mx = sps + max_dev;
  k->sps = sps;
  k->mx = mx;
  k->mi08 = mi * 0.8f;
  k->mx12 = mx * 1.2f;
  k->lo = mi - sps;
  k->hi = mx - sps;
  for (int j = 0; j < kMaxTaps; ++j) k->taps[j] = j < ntaps ? taps[j] : 0.0f;
  k->ntaps = ntaps;
  return true;
}

// Floats of filter history that a channel's state row keeps.
inline int history_len(int ntaps) { return ntaps > 1 ? ntaps - 1 : 1; }

// The clock filter with NT taps: ret = taps[0]*sample + sum_j taps[j+1] *
// hist[j], in that order, clamped to [lo, hi]; the history (newest first)
// shifts in ret.  A one-tap filter has no history; its state row keeps one
// float that nothing reads.
template <int NT>
struct ClockFilter {
  static constexpr int kHist = NT - 1;
  float hist[kHist > 0 ? kHist : 1];

  __device__ __forceinline__ void load(const Consts&, const float* st) {
#pragma unroll
    for (int j = 0; j < kHist; ++j) hist[j] = st[j];
  }
  __device__ __forceinline__ void store(const Consts&, float* st) const {
#pragma unroll
    for (int j = 0; j < kHist; ++j) st[j] = hist[j];
  }
  __device__ __forceinline__ float step(const Consts& k, float sample) {
    float ret = __fmul_rn(k.taps[0], sample);
#pragma unroll
    for (int j = 0; j < kHist; ++j)
      ret = __fadd_rn(ret, __fmul_rn(k.taps[j + 1], hist[j]));
    ret = fminf(fmaxf(ret, k.lo), k.hi);
#pragma unroll
    for (int j = kHist - 1; j > 0; --j) hist[j] = hist[j - 1];
    if (kHist > 0) hist[0] = ret;
    return ret;
  }
  // step() in two halves, for a caller that decides afterwards whether the
  // step happened: the clamped output, and the history's shift
  __device__ __forceinline__ float output(const Consts& k, float sample) const {
    float ret = __fmul_rn(k.taps[0], sample);
#pragma unroll
    for (int j = 0; j < kHist; ++j)
      ret = __fadd_rn(ret, __fmul_rn(k.taps[j + 1], hist[j]));
    return fminf(fmaxf(ret, k.lo), k.hi);
  }
  __device__ __forceinline__ void push_if(const Consts&, bool on, float ret) {
#pragma unroll
    for (int j = kHist - 1; j > 0; --j) hist[j] = on ? hist[j - 1] : hist[j];
    if (kHist > 0) hist[0] = on ? ret : hist[0];
  }
};

// Any tap count up to kMaxTaps: the steps past the filter's order are
// predicated off, so the history still lives in registers.
template <>
struct ClockFilter<0> {
  float hist[kMaxTaps - 1];

  __device__ __forceinline__ void load(const Consts& k, const float* st) {
#pragma unroll
    for (int j = 0; j < kMaxTaps - 1; ++j)
      hist[j] = j < k.ntaps - 1 ? st[j] : 0.0f;
  }
  __device__ __forceinline__ void store(const Consts& k, float* st) const {
#pragma unroll
    for (int j = 0; j < kMaxTaps - 1; ++j)
      if (j < k.ntaps - 1) st[j] = hist[j];
  }
  __device__ __forceinline__ float step(const Consts& k, float sample) {
    const int order = k.ntaps - 1;
    float ret = __fmul_rn(k.taps[0], sample);
#pragma unroll
    for (int j = 0; j < kMaxTaps - 1; ++j)
      if (j < order) ret = __fadd_rn(ret, __fmul_rn(k.taps[j + 1], hist[j]));
    ret = fminf(fmaxf(ret, k.lo), k.hi);
#pragma unroll
    for (int j = kMaxTaps - 2; j > 0; --j)
      if (j < order) hist[j] = hist[j - 1];
    if (order > 0) hist[0] = ret;
    return ret;
  }
  __device__ __forceinline__ float output(const Consts& k, float sample) const {
    const int order = k.ntaps - 1;
    float ret = __fmul_rn(k.taps[0], sample);
#pragma unroll
    for (int j = 0; j < kMaxTaps - 1; ++j)
      if (j < order) ret = __fadd_rn(ret, __fmul_rn(k.taps[j + 1], hist[j]));
    return fminf(fmaxf(ret, k.lo), k.hi);
  }
  __device__ __forceinline__ void push_if(const Consts& k, bool on, float ret) {
    const int order = k.ntaps - 1;
#pragma unroll
    for (int j = kMaxTaps - 2; j > 0; --j)
      if (on && j < order) hist[j] = hist[j - 1];
    if (on && order > 0) hist[0] = ret;
  }
};

// The reference's timing-error loop (src/symbol_sync.rs:150-160), as kernel
// E runs it:  while t > mx { t2 = t - clock; if |t - clock| < |t2 - clock|
// break; t = t2 }.  t - clock and t2 are one value, and t2 - clock is the
// next round's t2.
__device__ __forceinline__ float ted_walk(float t, float clock, float mx) {
  float t2 = __fsub_rn(t, clock);
  while (t > mx) {
    const float t3 = __fsub_rn(t2, clock);
    if (fabsf(t2) < fabsf(t3)) break;
    t = t2;
    t2 = t3;
  }
  return t;
}

// _ted_reduce (rustradio_tpu/ops/symbol_sync.py:149-167), as kernel D runs
// it: the closed-form pre-reduction from the quotient q = (t0_raw - mx) /
// clock, then at most six steps of the loop above.  A step that changes
// nothing ends it: the steps after it would see the same t and change
// nothing either.
__device__ __forceinline__ float ted_reduce(float t0_raw, float q, float clock,
                                            float mx) {
  const float k0 = fmaxf(0.0f, __fsub_rn(floorf(q), 1.0f));
  float t = __fsub_rn(t0_raw, __fmul_rn(k0, clock));
  float t2 = __fsub_rn(t, clock);
#pragma unroll 1
  for (int s = 0; s < 6 && t > mx; ++s) {
    const float t3 = __fsub_rn(t2, clock);
    if (!(fabsf(t2) >= fabsf(t3))) break;
    t = t2;
    t2 = t3;
  }
  return t;
}

// ---- kernel E: the per-sample recurrence, walked from event to event

// What the loader leaves for the walker: the offsets in the tile of its
// crossing samples (sign unlike the sample before), ascending, then the
// tile's length twice, so that the walker reads one entry ahead.
struct ScanIn {
  uint16_t cross[kTile + 2];
  int count;
};

// What a tile of kernel E leaves for the flushers.  The gaps the walker
// jumped with a crossing at their end (ng): each one's first sample and its
// samples, crossing included (span: first | samples << 16), its first
// position and its middle; the flushers place its emissions (ScanWalker::
// straight).  The other samples that emitted (ne, ascending), the samples
// after which the clock changed (nc, ascending) and the clocks, list[0] the
// clock at the tile's first sample and list[j + 1] the clock after
// changes[j].  The flushers turn the lists into bit words (a sample's clock
// is list[base[w] + the changes in its word before it]).  The walker's
// stores past a list's end are overwritten or never read.
struct ScanTile {
  float gpos[kTile + 1];
  float gmid[kTile + 1];
  int span[kTile + 1];
  float list[kTile + 1];
  uint16_t emits[kTile + 8];
  uint16_t changes[kTile + 2];
  uint32_t emit[kWords];
  uint32_t chg[kWords];
  int base[kWords];
  int ne, nc, ng;
};

// Loader: the crossings of tile `tile` of the row (__ballot_sync, then a
// __popc prefix gives each its slot); `prev` is the sign before the tile:
// the state's last sign for the first tile, else the sample before it.
// Samples past the row hold no crossing.  The tile's 32 loads a lane are
// all in flight before the first ballot: one wait for device memory a
// tile, not one a word (32 waits take about as long as the walker's tile).
__device__ __forceinline__ void load_crossings(const float* __restrict__ xr,
                                               long long n, long long tile,
                                               bool prev, ScanIn& in,
                                               int lane) {
  const long long i0 = tile * kTile;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t last = tile == 0 ? (uint32_t)prev : __ldg(xr + i0 - 1) > 0.0f;
  float v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const long long i = i0 + w * 32 + lane;
    v[w] = i < n ? __ldg(xr + i) : 0.0f;
  }
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const long long i = i0 + w * 32 + lane;
    const uint32_t sw = __ballot_sync(0xffffffffu, v[w] > 0.0f);
    const uint32_t live = __ballot_sync(0xffffffffu, i < n);
    const uint32_t cross = (sw ^ ((sw << 1) | last)) & live;
    if ((cross >> lane) & 1u) in.cross[count + __popc(cross & below)] = w * 32 + lane;
    count += __popc(cross);
    last = sw >> 31;
  }
  if (lane == 0) {
    const int len = (int)min((long long)kTile, n - i0);
    in.cross[count] = len;
    in.cross[count + 1] = len;
    in.count = count;
  }
}

// The two flusher warps alone (named barrier 1).
__device__ __forceinline__ void flushers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kFlushers) : "memory");
}

// The least j with pos + j (one rounded addition) >= mid, where it is at
// most the jump limit of pos (ScanWalker, Positions).
__device__ __forceinline__ float first_at(float pos, float mid) {
  const float e0 = ceilf(fminf(fmaxf(__fsub_rn(mid, pos), 0.0f), 4096.0f));
  const bool dn = (e0 > 0.0f) & (__fadd_rn(pos, __fsub_rn(e0, 1.0f)) >= mid);
  const bool up = __fadd_rn(pos, e0) < mid;
  return __fadd_rn(e0, dn ? -1.0f : up ? 1.0f : 0.0f);
}

// Flushers: mask bytes and clocks of the tile's `len` samples, from the
// walker's lists: the clock changes and the listed emissions first, then
// the emissions of the jumped gaps, each from its first position and
// middle by the clock at its first sample.
__device__ __forceinline__ void flush_scan(ScanTile& out, int len,
                                           unsigned char* __restrict__ mr,
                                           float* __restrict__ cr, int rank) {
  if (rank < kWords)
    out.emit[rank] = 0u;
  else if (rank < 2 * kWords)
    out.chg[rank - kWords] = 0u;
  flushers_sync();
  for (int i = rank; i < out.ne; i += kFlushers)
    atomicOr(&out.emit[out.emits[i] >> 5], 1u << (out.emits[i] & 31));
  for (int i = rank; i < out.nc; i += kFlushers)
    atomicOr(&out.chg[out.changes[i] >> 5], 1u << (out.changes[i] & 31));
  flushers_sync();
  if (rank < kWords) {  // base[w]: the clock changes before word w
    const int own = __popc(out.chg[rank]);
    int sum = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, sum, d);
      if (rank >= d) sum += v;
    }
    out.base[rank] = sum - own;
  }
  flushers_sync();
  for (int i = rank; i < out.ng; i += kFlushers) {
    const int b = out.span[i] & 0xffff, w = b >> 5;
    const float pos = out.gpos[i];
    const float clock =
        out.list[out.base[w] + __popc(out.chg[w] & ((1u << (b & 31)) - 1u))];
    const float last = __fadd_rn(pos, __int2float_rn((out.span[i] >> 16) - 1));
    for (float nm = out.gmid[i]; nm <= last; nm = __fadd_rn(nm, clock)) {
      const int j = b + __float2int_rz(first_at(pos, nm));
      atomicOr(&out.emit[j >> 5], 1u << (j & 31));
    }
  }
  flushers_sync();
  for (int j = rank; j < len; j += kFlushers) {
    const int w = j >> 5, l = j & 31;
    mr[j] = (out.emit[w] >> l) & 1u;
    cr[j] = out.list[out.base[w] + __popc(out.chg[w] & ((1u << l) - 1u))];
  }
}

// The walker of kernel E.  state row: [clock, last_sign, stream_pos,
// last_boundary, next_mid, history...].
//
// Positions.  Every sample's step ends with pos + 1, rounded.  From pos in
// [1, 2^21), the reference's position after j such steps (no step back
// between) is P(j) = pos + j in one rounded addition while pos + j < 4 top
// (top: the power of two above pos).  Below top each sum is exact (1 is a
// whole number of pos's last places); the sum that reaches top rounds once
// to the next binade's grid, whose sums are exact again, and so on at 2
// top.  One rounding of pos + j to the grid at 2 top equals the two
// roundings, ties included: to even at each (the grids halve and double,
// and j is a whole multiple of twice their spacing).  A third top would
// break that.  So a jump of up to top + ceil(top - pos) - 1 + 2 top
// samples (jump_limit) is one addition, and P(j) lies within 3/8 of pos +
// j.  chip_smoke.py checks it exhaustively over every f32 position.
//
// A sample's emission test passes where P(j) >= next_mid: the least such j
// is within one of ceil(next_mid - pos), the difference rounded once, and
// the exact compares of P at that estimate and one below settle it
// (first_at).
template <int NT>
struct ScanWalker {
  float clock, pos, last_b, next_mid, sb;
  uint32_t last_sign;
  int crossings, stepped;  // crossings walked, samples stepped one by one
  uint16_t* ev;            // the tile's listed emissions, ne so far
  int ne, ng;              // and its jumped gaps
  ClockFilter<NT> filt;

  __device__ __forceinline__ void load(const Consts& k, const float* st) {
    clock = st[0];
    last_sign = st[1] != 0.0f;
    pos = st[2];
    last_b = st[3];
    next_mid = st[4];
    sb = __fmul_rn(10.0f, clock);
    crossings = 0;
    stepped = 0;
    filt.load(k, st + 5);
  }
  __device__ __forceinline__ void store(const Consts& k, float* st) const {
    st[0] = clock;
    st[1] = last_sign ? 1.0f : 0.0f;
    st[2] = pos;
    st[3] = last_b;
    st[4] = next_mid;
    filt.store(k, st + 5);
  }

  // The end of every sample's step: advance, and step back by 10 clocks to
  // stay near zero (src/symbol_sync.rs:200-209).
  __device__ __forceinline__ void advance() {
    pos = __fadd_rn(pos, 1.0f);
    const bool back = (pos > sb) & (last_b > sb) & (next_mid > sb);
    pos = back ? __fsub_rn(pos, sb) : pos;
    last_b = back ? __fsub_rn(last_b, sb) : last_b;
    next_mid = back ? __fsub_rn(next_mid, sb) : next_mid;
  }

  // The emission test that opens every sample's step, at sample b.
  __device__ __forceinline__ void emit(int b) {
    const bool due = pos >= next_mid;
    ev[ne] = b;
    ne += due;
    next_mid = due ? __fadd_rn(next_mid, clock) : next_mid;
  }

  // The most samples a jump from pos may cover (Positions, above).
  __device__ __forceinline__ float jump_limit() const {
    const float top =
        __int_as_float((__float_as_int(pos) & 0x7f800000) + 0x00800000);
    return __fadd_rn(__fmul_rn(3.0f, top),
                     __fsub_rn(ceilf(__fsub_rn(top, pos)), 1.0f));
  }

  // Whether the g samples from here to P(g) = pg, none a crossing, are one
  // jump: pos in [1, 2^21) and P(g) under 4 top (Positions), the clock at
  // least 2 and the middle past P(-1), so that each emission lands past
  // the sample of the one before and is first_at's j, and no step back in
  // between (the boundary is behind 10 clocks, or so is P(g)).
  __device__ __forceinline__ bool jumpable(float pg) const {
    const float top4 =
        __int_as_float((__float_as_int(pos) & 0x7f800000) + 0x01800000);
    return (pos >= 1.0f) & (pos < 2097152.0f) & (pg < top4) &
           (clock >= 2.0f) & (__fsub_rn(next_mid, pos) > -1.0f) &
           !((last_b > sb) & (pg > sb));
  }

  // Samples b .. b + g - 1, none a crossing: the emission test, pos + 1
  // and the step-back test each.  A jumpable gap's emissions are
  // next_mid, next_mid + clock, ... while they reach P(g - 1); any other
  // gap takes quiet().
  __device__ __forceinline__ void gap(int b, int g) {
    const float pg = __fadd_rn(pos, __int2float_rn(g));
    if (!jumpable(pg)) {
      quiet(b, g);
      return;
    }
    const float last = __fadd_rn(pos, __int2float_rn(g - 1));
    for (; next_mid <= last; next_mid = __fadd_rn(next_mid, clock))
      ev[ne++] = b + __float2int_rz(first_at(pos, next_mid));
    pos = pg;
  }

  // A gap that is not jumpable, in jumps from event to event: to the
  // sample of the first emission (first_at), the sample after which the
  // first step back can come (the least j with P(j + 1) > 10 clocks, found
  // the same way, where the boundary allows one; the middle's test is made
  // there), or the jump limit, whichever is first.  Below 1, at 2^21 or
  // more, or with a NaN middle the walker takes the reference's step
  // sample by sample, and counts it.
  __device__ __forceinline__ void quiet(int b, int r) {
    while (r > 0) {
      const float d = __fsub_rn(next_mid, pos);
      if (!(pos >= 1.0f && pos < 2097152.0f) || d != d) {
        emit(b);
        advance();
        ++b;
        --r;
        ++stepped;
        continue;
      }
      const float m = fminf(__int2float_rn(r), jump_limit());
      const float e = first_at(pos, next_mid);
      float s = m;
      if (last_b > sb) {
        const float ds = fminf(fmaxf(__fsub_rn(sb, pos), 0.0f), 4096.0f);
        const float i0 = __fadd_rn(floorf(ds), 1.0f);
        const bool s_dn =
            i0 > 1.0f && __fadd_rn(pos, __fsub_rn(i0, 1.0f)) > sb;
        const bool s_up = !(__fadd_rn(pos, i0) > sb);
        s = s_dn ? __fsub_rn(i0, 2.0f) : s_up ? i0 : __fsub_rn(i0, 1.0f);
      }
      const float kf = fminf(fminf(e, s), m);
      const bool event = kf < m;
      const float adv = event ? __fadd_rn(kf, 1.0f) : m;
      pos = __fadd_rn(pos, adv);
      if (event && kf == e) {
        ev[ne++] = b + __float2int_rz(kf);
        next_mid = __fadd_rn(next_mid, clock);
      }
      if (event && kf == s && next_mid > sb) {
        pos = __fsub_rn(pos, sb);
        last_b = __fsub_rn(last_b, sb);
        next_mid = __fsub_rn(next_mid, sb);
      }
      const int n = __float2int_rz(adv);
      b += n;
      r -= n;
    }
  }

  // Sample c, a crossing: the reference's step, each operation as it
  // rounds it.
  __device__ __forceinline__ void crossing(const Consts& k, int c,
                                           ScanTile& out, int& nc) {
    emit(c);
    if (pos > 0.0f && last_b > 0.0f) {
      const float t = ted_walk(__fsub_rn(pos, last_b), clock, k.mx);
      if (t > k.mi08 && t < k.mx12) {
        clock = __fadd_rn(filt.step(k, __fsub_rn(t, k.sps)), k.sps);
        sb = __fmul_rn(10.0f, clock);
        float nm = __fadd_rn(last_b, __fmul_rn(clock, 0.5f));
        while (nm < pos) nm = __fadd_rn(nm, clock);
        next_mid = nm;
        out.changes[nc] = c;
        out.list[++nc] = clock;
      }
    }
    last_b = pos;
    advance();
  }

  // gap(b, c - b) and crossing(c) as one run of code with no branch.  A
  // jumpable gap's emissions and the crossing's own (that sample's test is
  // pos = P(g) >= the middle) are next_mid, next_mid + clock, ... while
  // they reach P(g): the walker counts up to five of them and leaves the
  // gap to the flushers, who place them (flush_scan).  Each loop's first
  // rounds run unconditionally, one chain of additions with its compares
  // beside it, and a select keeps the round the loop would have stopped
  // at: five of the middle's, four of the timing-error walk, four of the
  // next middle's catch-up.  Returns false, the walker's state then being
  // of no use, where the gap is not jumpable or a loop needs a round more:
  // the caller then walks the two from the state before.
  __device__ __forceinline__ bool straight(const Consts& k, int b, int c,
                                           ScanTile& out, int& nc) {
    const float pg = __fadd_rn(pos, __int2float_rn(c - b));
    const float m0 = next_mid;
    bool ok = jumpable(pg);
    out.gpos[ng] = pos;
    out.gmid[ng] = m0;
    out.span[ng] = b | (c - b + 1) << 16;
    ++ng;
    const float m1 = __fadd_rn(m0, clock), m2 = __fadd_rn(m1, clock);
    const float m3 = __fadd_rn(m2, clock), m4 = __fadd_rn(m3, clock);
    const float m5 = __fadd_rn(m4, clock);
    float nm = m4 <= pg ? m5 : m4;
    nm = m3 <= pg ? nm : m3;
    nm = m2 <= pg ? nm : m2;
    nm = m1 <= pg ? nm : m1;
    nm = m0 <= pg ? nm : m0;
    ok &= !(m5 <= pg);
    pos = pg;
    // the timing-error walk: while t > mx and t - clock is no farther from
    // zero than t - 2 clock, t -= clock
    const float t0 = __fsub_rn(pos, last_b);
    const float t1 = __fsub_rn(t0, clock), t2 = __fsub_rn(t1, clock);
    const float t3 = __fsub_rn(t2, clock), t4 = __fsub_rn(t3, clock);
    const float t5 = __fsub_rn(t4, clock);
    const bool s1 = (t0 > k.mx) & !(fabsf(t1) < fabsf(t2));
    const bool s2 = s1 & (t1 > k.mx) & !(fabsf(t2) < fabsf(t3));
    const bool s3 = s2 & (t2 > k.mx) & !(fabsf(t3) < fabsf(t4));
    const bool s4 = s3 & (t3 > k.mx) & !(fabsf(t4) < fabsf(t5));
    const float t = s4 ? t4 : s3 ? t3 : s2 ? t2 : s1 ? t1 : t0;
    ok &= !(s4 & (t4 > k.mx));
    const bool apply =
        (pos > 0.0f) & (last_b > 0.0f) & (t > k.mi08) & (t < k.mx12);
    const float ret = filt.output(k, __fsub_rn(t, k.sps));
    filt.push_if(k, apply, ret);
    const float nclk = __fadd_rn(ret, k.sps);
    // the next middle: boundary + clock / 2, bumped up to pos
    const float c0 = __fadd_rn(last_b, __fmul_rn(nclk, 0.5f));
    const float c1 = __fadd_rn(c0, nclk), c2 = __fadd_rn(c1, nclk);
    const float c3 = __fadd_rn(c2, nclk), c4 = __fadd_rn(c3, nclk);
    float mid = c3 < pos ? c4 : c3;
    mid = c2 < pos ? mid : c2;
    mid = c1 < pos ? mid : c1;
    mid = c0 < pos ? mid : c0;
    ok &= !(apply & (c4 < pos));
    clock = apply ? nclk : clock;
    sb = apply ? __fmul_rn(10.0f, nclk) : sb;
    next_mid = apply ? mid : nm;
    out.changes[nc] = c;
    out.list[nc + 1] = clock;
    nc += apply;
    last_b = pos;
    advance();
    return ok;
  }

  // `len` samples from the loader's crossing list; no global access.  The
  // walk goes crossing by crossing through straight(); a crossing it
  // cannot take is walked again by gap() and crossing(), out of the
  // common path's way.
  __device__ __forceinline__ void tile(const Consts& k, const ScanIn& in,
                                       int len, ScanTile& out) {
    ev = out.emits;
    ne = 0;
    ng = 0;
    int nc = 0, wc = 0, i = 1, b = 0, c = in.cross[0], next = 0;
    ScanWalker w;
    out.list[0] = clock;
    if (c >= len) goto tail;
  walk:
    next = in.cross[i++];
    w = *this;
    wc = nc;
    if (__builtin_expect(!w.straight(k, b, c, out, wc), 0)) goto again;
    *this = w;
    nc = wc;
  step:
    b = c + 1;
    c = next;
    if (c < len) goto walk;
  tail:
    gap(b, len - b);
    out.ne = ne;
    out.nc = nc;
    out.ng = ng;
    crossings += in.count;
    last_sign ^= (uint32_t)in.count & 1u;
    return;
  again:
    gap(b, c - b);
    crossing(k, c, out, nc);
    goto step;
  }
};

// ---- kernel D: the event step over crossing slots

constexpr int kGroup = 4;  // slots a straight stretch of kernel D takes at once

// Loader: the positions of tile `tile` of the slot row into `ev`, and into
// *count its real slots, those before the row's first padding slot
// (position >= n; slots past the row count as padding).  `real` is the
// row's count of real slots where the caller knows it; below 0 the loader
// finds the tile's first padding slot by a ballot.  The tile's 32 loads a
// lane are all in flight before the first store or ballot, and the kGroup
// slots after the tile hold n, so that the walker reads the next group's
// positions ahead without a clamp.
__device__ __forceinline__ void load_slots(const int* __restrict__ er,
                                           int n_events, int n, int tile,
                                           int real, int* ev, int* count,
                                           int lane) {
  const int i0 = tile * kTile;
  int v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int j = w * 32 + lane;
    v[w] = i0 + j < n_events ? __ldg(er + i0 + j) : n;
  }
  int first = kTile;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    ev[w * 32 + lane] = v[w];
    if (real < 0) {
      const uint32_t pad = __ballot_sync(0xffffffffu, v[w] >= n);
      if (pad && first == kTile) first = w * 32 + __ffs(pad) - 1;
    }
  }
  if (lane < kGroup) ev[kTile + lane] = n;
  if (real >= 0) first = min(max(real - i0, 0), kTile);
  if (lane == 0) *count = first;
}

// A fast reciprocal (one MUFU.RCP; subnormals flushed), for the straight
// stretch's quotients only.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Whether r is within 2^-21 of 1/c, relative: e = 1 - c r in one rounding
// (an FMA) measures its error, whatever the hardware's approximation gives.
__device__ __forceinline__ bool rcp_close(float c, float r) {
  return fabsf(__fmaf_rn(-c, r, 1.0f)) <= 0x1p-21f;
}

// Whether q = x * r (one rounding, r within 2^-21 of 1/c) has the floor and
// the ceiling of __fdiv_rn(x, c).  Proof: with e = 1 - c r, |e| <= 2^-21
// (1 + 2^-23), q = (x / c)(1 - e)(1 + d) + s with |d| <= 2^-24 and |s| <=
// 2^-150 (a subnormal product), so |q - x / c| <= |x / c| 2^-20.8 +
// 2^-149; the rounded quotient lies within |x / c| 2^-24 + 2^-150 of x /
// c.  Both therefore lie within |q| 2^-19.7 + 2^-147 of q, less than tol
// = |q| 2^-18 + 2^-100 however tol rounds.  Where q's distance to its
// nearest integer exceeds tol (that distance is exact: q - rint(q) is
// exact below 2^23, and q is whole above), no integer lies between q, x /
// c and the rounded quotient, nor on one of them: their floors are equal,
// their ceilings are equal, and both have q's sign (a ceiling of -0 for q
// in (-1, 0) included).  NaN and infinities fail the test.
__device__ __forceinline__ bool floor_exact(float q) {
  return fabsf(__fsub_rn(q, rintf(q))) >
         __fmaf_rn(fabsf(q), 0x1p-18f, 0x1p-100f);
}

// The walker of kernel D.  fstate row: [clock, mid_off, bnd_off,
// history...]; istate row: [p_prev, have_boundary, started].
//
// A slot is one step of the JAX scan's event_step: its two quotients by
// the clock, the timing error reduced (ted_reduce), then either the clock
// filter and the next middle (the crossing applied), or the emissions in
// the gap bumping the middle on.  Two paths compute it, bit for bit the
// same:
//   * step(), the general path: the scan's operations as written, with
//     __fdiv_rn and ted_reduce's loop;
//   * straight(), one stretch with no branch, for the common slot (the
//     state past its first boundary, the reduction done in two rounds,
//     every quotient's floor decided): the quotients' floors and ceilings
//     from the reciprocal of the clock (floor_exact), carried beside it and
//     taken again only where a crossing applies; the reduction as a chain
//     of subtractions with their compares beside it and a select, the
//     clock filter run on each of its three outcomes meanwhile; both arms
//     of the apply test computed and committed by selects, the filter's
//     history shifted only where the crossing applies.  It says whether
//     the slot was common.
// tile() walks kGroup slots at a time through straight(), one run of code
// the compiler schedules across the slots (slot j's next middle beside
// slot j + 1's clock), and where a group holds a slot that is not common,
// walks that group again slot by slot, each slot that is not common
// through step().  The clock is the recurrence's chain: a quotient, the
// reduction, the filter and the reciprocal of the new clock.
template <int NT>
struct EventsWalker {
  float clock, mid_off, bnd_off;
  float rcp;  // ~1 / clock
  int p_prev;
  bool have_b, started, rcp_ok;  // rcp_ok: rcp_close(clock, rcp)
  int walked, general;           // slots walked, and through step()
  ClockFilter<NT> filt;

  __device__ __forceinline__ void load(const Consts& k, const float* fs,
                                       const int* is) {
    clock = fs[0];
    mid_off = fs[1];
    bnd_off = fs[2];
    filt.load(k, fs + 3);
    p_prev = is[0];
    have_b = is[1] != 0;
    started = is[2] != 0;
    rcp = rcp_approx(clock);
    rcp_ok = rcp_close(clock, rcp);
    walked = 0;
    general = 0;
  }
  __device__ __forceinline__ void store(const Consts& k, float* fs,
                                        int* is) const {
    fs[0] = clock;
    fs[1] = mid_off;
    fs[2] = bnd_off;
    filt.store(k, fs + 3);
    is[0] = p_prev;
    is[1] = have_b ? 1 : 0;
  }

  // The slot at p on the general path; the state after it to om / oc.
  __device__ __forceinline__ void step(const Consts& k, int p, float* om,
                                       float* oc) {
    const int gap_i = p - p_prev;
    const float gap = __int2float_rn(gap_i);
    const float t0_raw = __fadd_rn(gap, bnd_off);
    const float q_mid = __fdiv_rn(__fsub_rn(gap, mid_off), clock);
    const float q_ted = __fdiv_rn(__fsub_rn(t0_raw, k.mx), clock);
    const float t = ted_reduce(t0_raw, q_ted, clock, k.mx);
    const bool past_start = started || p > 0;
    if (past_start && have_b && t > k.mi08 && t < k.mx12) {
      const float new_clock =
          __fadd_rn(filt.step(k, __fsub_rn(t, k.sps)), k.sps);
      // next middle = boundary + clock/2, bumped to >= p in closed form
      const float nm0 = __fsub_rn(__fmul_rn(new_clock, 0.5f), t0_raw);
      const float kk = fmaxf(0.0f, ceilf(__fdiv_rn(-nm0, new_clock)));
      clock = new_clock;
      mid_off = fmaxf(__fadd_rn(nm0, __fmul_rn(kk, new_clock)), 0.0f);
      rcp = rcp_approx(clock);
      rcp_ok = rcp_close(clock, rcp);
    } else {
      // emissions in (p_prev, p] bump mid before the crossing adjusts it
      const int e_unc = (int)floorf(q_mid) + 1;
      const int emitted = min(max(e_unc, 0), gap_i);
      mid_off = __fsub_rn(
          __fadd_rn(mid_off, __fmul_rn(__int2float_rn(emitted), clock)), gap);
    }
    p_prev = p;
    bnd_off = 0.0f;
    have_b = past_start;
    *om = mid_off;
    *oc = clock;
    ++general;
  }

  // The slot at p as step() computes it, in one stretch with no branch;
  // false (the state then of no use) where the slot is not common.
  __device__ __forceinline__ bool straight(const Consts& k, int p, float& om,
                                           float& oc) {
    const int gap_i = p - p_prev;
    const float gap = __int2float_rn(gap_i);
    const float t0_raw = __fadd_rn(gap, bnd_off);
    const float q_ted = __fmul_rn(__fsub_rn(t0_raw, k.mx), rcp);
    const float q_mid = __fmul_rn(__fsub_rn(gap, mid_off), rcp);
    bool ok = rcp_ok & have_b & (started | (p > 0)) & floor_exact(q_ted);
    // ted_reduce: from t0_raw - k0 clock, while t > mx and t - clock is no
    // farther from zero than t - 2 clock, t -= clock (two rounds here).
    // k0 = max(0, floor(q_ted) - 1) is max(0, rint(q_ted - 1.5)), rounded
    // by adding and taking off 1.5 2^23: where floor_exact holds, |q_ted| <
    // 2^17 and q_ted is no integer, so from q_ted >= 2 on q_ted - 1.5 is
    // exact and no half-integer, its nearest integer floor - 1, and below 2
    // both are at most 0
    const float k0 = fmaxf(0.0f, __fsub_rn(__fadd_rn(__fsub_rn(q_ted, 1.5f),
                                                     0x1.8p23f), 0x1.8p23f));
    const float u0 = __fsub_rn(t0_raw, __fmul_rn(k0, clock));
    const float u1 = __fsub_rn(u0, clock), u2 = __fsub_rn(u1, clock);
    const float u3 = __fsub_rn(u2, clock), u4 = __fsub_rn(u3, clock);
    const bool a1 = (u0 > k.mx) & (fabsf(u1) >= fabsf(u2));
    const bool a2 = a1 & (u1 > k.mx) & (fabsf(u2) >= fabsf(u3));
    ok &= !(a2 & (u2 > k.mx) & (fabsf(u3) >= fabsf(u4)));
    const float t = a2 ? u2 : a1 ? u1 : u0;
    const bool apply = (t > k.mi08) & (t < k.mx12);
    // the filter on each outcome of the reduction, beside its compares
    const float o0 = filt.output(k, __fsub_rn(u0, k.sps));
    const float o1 = filt.output(k, __fsub_rn(u1, k.sps));
    const float o2 = filt.output(k, __fsub_rn(u2, k.sps));
    const float ret = a2 ? o2 : a1 ? o1 : o0;
    filt.push_if(k, apply, ret);
    const float nclk = __fadd_rn(ret, k.sps);
    const float nrcp = rcp_approx(nclk);
    const bool nrcp_ok = rcp_close(nclk, nrcp);
    // applied: the next middle = boundary + clock / 2, bumped to >= p
    const float nm0 = __fsub_rn(__fmul_rn(nclk, 0.5f), t0_raw);
    const float q_kk = __fmul_rn(-nm0, nrcp);
    const float kk = fmaxf(0.0f, ceilf(q_kk));
    const float mid_a = fmaxf(__fadd_rn(nm0, __fmul_rn(kk, nclk)), 0.0f);
    // not applied: the emissions in (p_prev, p] bump the middle on; the
    // count min(max(floor + 1, 0), gap) in f32 is exact, the floor being
    // under 2^23 (floor_exact)
    const float e =
        fminf(fmaxf(__fadd_rn(floorf(q_mid), 1.0f), 0.0f), gap);
    const float mid_b = __fsub_rn(__fadd_rn(mid_off, __fmul_rn(e, clock)), gap);
    ok &= apply ? nrcp_ok & floor_exact(q_kk) : floor_exact(q_mid);
    clock = apply ? nclk : clock;
    rcp = apply ? nrcp : rcp;
    mid_off = apply ? mid_a : mid_b;
    p_prev = p;
    bnd_off = 0.0f;
    om = mid_off;
    oc = clock;
    return ok;
  }

  // event_step over `cnt` real slots at ev (kGroup readable past them); the
  // state after each goes to om / oc.  No global access.
  __device__ __forceinline__ void tile(const Consts& k, const int* ev, int cnt,
                                       float* om, float* oc) {
    int p[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) p[g] = ev[g];
    int j = 0;
    while (j < cnt) {
      int stop = cnt;
      if (j + kGroup <= cnt) {
        int next[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) next[g] = ev[j + kGroup + g];
        EventsWalker w = *this;
        bool ok = true;
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          ok &= w.straight(k, p[g], om[j + g], oc[j + g]);
        if (__builtin_expect(ok, 1)) {
          *this = w;
          j += kGroup;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) p[g] = next[g];
          continue;
        }
        stop = j + kGroup;
      }
      // a group with a slot that is not common, or the tile's last slots
#pragma unroll 1
      for (; j < stop; ++j) {
        EventsWalker w = *this;
        if (w.straight(k, ev[j], om[j], oc[j]))
          *this = w;
        else
          step(k, ev[j], om + j, oc + j);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) p[g] = ev[j + g];
    }
    walked += cnt;
  }
};

// Flushers: the per-slot state of a tile's `cnt` real slots.
__device__ __forceinline__ void flush_slots(const float* sm, const float* sc,
                                            int cnt, float* __restrict__ om,
                                            float* __restrict__ oc, int rank) {
  for (int j = rank; j < cnt; j += kFlushers) {
    om[j] = sm[j];
    oc[j] = sc[j];
  }
}

}  // namespace sync
}  // namespace rr
