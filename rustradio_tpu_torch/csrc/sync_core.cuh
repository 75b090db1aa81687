// The core of kernels D and E (symbol_sync.cu): the clock recovery's
// constants, its clock filter and timing-error reduction, and the roles of
// a block that walks one channel.
//
// What bounds clock recovery on an H100.  Each sample (kernel E) or crossing
// slot (kernel D) needs the clock and offsets that the one before it left,
// so a channel is one lane walking its stream.  Bytes and operations are
// nowhere near a limit (9 B and two operations a sample).  The least time is
// the longest recurrence of the busiest channel, each f32 operation rounded
// on its own, at the card's latency between dependent operations
// (chip_smoke.py measures it with tools/csrc/chain_calib.cu and counts the
// chains from the run's data).  In kernel D that is clock to clock over the
// slots whose crossing is applied: one division, ten operations and the
// filter, 123-141 cycles; the gap, the second quotient and the next middle
// run beside it.  In kernel E it is the clock filter over applied crossings
// (~58 cycles each); the positions between two step backs are one exact
// addition (add_ones), so they hold nothing.  Measured on an H100 at 700 W,
// a lone lane pays 4.4 cycles for a dependent addition, 44.6 for an IEEE
// division, ~14 for a compare it has to wait for and ~25 for every taken
// branch, and the walkers take ~470 cycles a real slot (D) and ~38 a sample
// (E): D runs at about a quarter of its chain, E at about a fiftieth of
// its.  Control flow and running every sample's tests on one lane, not
// arithmetic, is what they pay for.  A lone lane that also loads its input
// and stores its results waits for every load on top: the
// one-thread-per-channel form (tools/csrc/symbol_sync_lone.cu) spends ~200
// cycles a sample and ~800 a real slot.
//
// What the design does about it: one block of kThreads per channel, with
// roles.
//   * the walker, lane 0 of warp 0, carries the recurrence and touches only
//     registers and shared memory; alone in its warp it pays no divergence;
//   * the loader, warp 1, brings the next tile of the channel's input into
//     shared memory with coalesced loads (a row starts at c*n elements, at
//     any 4-byte residue: a lane loads one element, so nothing is peeled)
//     and reduces it to what the walker needs: for kernel E one sign bit a
//     sample (__ballot_sync), for kernel D the slot positions and the
//     tile's first padding slot;
//   * the flushers, warps 2-3, write the walker's results of the previous
//     tile to device memory, coalesced, expanding kernel E's emit bits and
//     clock changes into the (C, N) mask bytes and clocks.
// Three tiles are in flight (load t+1, walk t, flush t-1) behind one
// __syncthreads() per tile; a tile takes the walker ~40,000 cycles, the
// loader and flushers a few hundred, so neither asynchronous copies nor
// mbarrier pairs would shorten anything.  Channels are independent blocks;
// more channels than the card holds at once queue.
//   * the clock filter is compiled per tap count (1, 2, 6; any count up to
//     16 through the general form), its history in registers;
//   * the timing-error reduction leaves at the first step that changes
//     nothing and carries t - clock into the next step;
//   * x / 2 is __fmul_rn(x, 0.5f): exact, as the division is;
//   * kernel E walks from crossing to crossing of a sign word (__ffs), and
//     between them proves runs of samples quiet (no emission, no step
//     back: ScanWalker::quiet_run), whose whole step is pos + 1; a run
//     inside the position's binade is one addition (ScanWalker::add_ones);
//   * kernel D takes each channel's count of real slots from the caller
//     where it has one, else the loader finds the first padding slot by a
//     ballot; either way the walker compares no sentinel.
//
// Numerics: every f32 operation is rounded on its own (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn), because nvcc contracts a*b+c into an
// FMA by default and one contraction moves an emission by a sample; each
// value is computed by the operations of the JAX scans
// (rustradio_tpu/ops/symbol_sync.py:87-143, :246-292) and of native
// rr_symbol_sync, in their order, so both kernels equal their plain PyTorch
// versions (ops/kernels.py) bit for bit.
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

// ---- kernel E: the per-sample recurrence

// What a tile of kernel E leaves for the flushers: a sample's mask byte is
// its bit of emit; its clock is list[base[w] + the bits of chg[w] below
// it], list[0] being the clock at the tile's first sample and each set bit
// of chg a sample after which the clock changed.
struct ScanTile {
  uint32_t emit[kWords];
  uint32_t chg[kWords];
  int base[kWords];
  float list[kTile + 1];
};

// Loader: the sign bits of tile `tile` of the row, 32 samples a word;
// samples past the row read as 0.
__device__ __forceinline__ void load_signs(const float* __restrict__ xr,
                                           long long n, long long tile,
                                           uint32_t* sign, int lane) {
  const long long i0 = tile * kTile + lane;
#pragma unroll 8
  for (int w = 0; w < kWords; ++w) {
    const long long i = i0 + w * 32;
    const float v = i < n ? __ldg(xr + i) : 0.0f;
    const uint32_t bits = __ballot_sync(0xffffffffu, v > 0.0f);
    if (lane == 0) sign[w] = bits;
  }
}

// Flushers: mask bytes and clocks of the tile's `len` samples.
__device__ __forceinline__ void flush_scan(const ScanTile& out, int len,
                                           unsigned char* __restrict__ mr,
                                           float* __restrict__ cr, int rank) {
  for (int j = rank; j < len; j += kFlushers) {
    const int w = j >> 5, l = j & 31;
    mr[j] = (out.emit[w] >> l) & 1u;
    cr[j] = out.list[out.base[w] + __popc(out.chg[w] & ((1u << l) - 1u))];
  }
}

// The walker of kernel E.  state row: [clock, last_sign, stream_pos,
// last_boundary, next_mid, history...].
template <int NT>
struct ScanWalker {
  float clock, pos, last_b, next_mid, sb;
  uint32_t last_sign;
  ClockFilter<NT> filt;

  __device__ __forceinline__ void load(const Consts& k, const float* st) {
    clock = st[0];
    last_sign = st[1] != 0.0f;
    pos = st[2];
    last_b = st[3];
    next_mid = st[4];
    sb = __fmul_rn(10.0f, clock);
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
  // stay near zero (src/symbol_sync.rs:200-209); true when it stepped back.
  __device__ __forceinline__ bool advance() {
    pos = __fadd_rn(pos, 1.0f);
    const bool back = pos > sb && last_b > sb && next_mid > sb;
    if (back) {
      pos = __fsub_rn(pos, sb);
      last_b = __fsub_rn(last_b, sb);
      next_mid = __fsub_rn(next_mid, sb);
    }
    return back;
  }

  // The emission test that opens every sample's step; true when it emitted.
  __device__ __forceinline__ bool emit(uint32_t& emits, int b) {
    const bool due = pos >= next_mid;
    const float bumped = __fadd_rn(next_mid, clock);
    if (due) {
      emits |= 1u << b;
      next_mid = bumped;
    }
    return due;
  }

  // `run` times pos = pos + 1, each sum rounded as the reference rounds it.
  // While pos >= 1, 1 is a whole number of pos's last places, and every
  // sum up to the top of pos's binade (the next power of two) is one too:
  // each addition is exact, and so is pos + run in one addition, the same
  // value.  A run that leaves the binade, or starts below 1, takes its
  // additions one by one.
  __device__ __forceinline__ void add_ones(int run) {
    const float top =
        __int_as_float((__float_as_int(pos) & 0x7f800000) + 0x00800000);
    const float jumped = __fadd_rn(pos, __int2float_rn(run));
    if (__builtin_expect(pos >= 1.0f && jumped <= top, 1)) {
      pos = jumped;
    } else {
#pragma unroll 1
      for (int i = 0; i < run; ++i) pos = __fadd_rn(pos, 1.0f);
    }
  }

  // How many samples from here provably neither emit nor step back, so
  // that their whole step is pos = pos + 1 (at most 32; 0 when that cannot
  // be shown).  While 0 <= pos < 2^17, each of up to 32 additions of 1
  // rounds by at most 2^-7 (half an ulp below 2^18), so the i-th position
  // from here is at most pos + i + 0.25; a difference of two such values,
  // and 0.73 added to it, are each off by at most 2^-7, under 0.02 in all.
  // No emission in r samples needs pos + (r - 1) + 0.25 < next_mid, that
  // is r < (next_mid - pos) + 0.75, which r <= floor((next_mid - pos) +
  // 0.73) gives; no step back needs pos + r + 0.25 <= 10 clocks, which
  // r <= floor((10 clocks - pos) - 0.27) gives, unless the boundary or the
  // middle, which such samples leave alone, forbids the step back anyway.
  // The positions themselves stay the sums of the reference, one rounding
  // a sample.  Written without branches: a compare that feeds a branch
  // costs a lone lane several additions' time.
  __device__ __forceinline__ int quiet_run() const {
    const bool in_range = pos >= 0.0f && pos < 131072.0f;
    const bool may_step_back = last_b > sb && next_mid > sb;
    const float to_mid = __fadd_rn(__fsub_rn(next_mid, pos), 0.73f);
    const float room = __fsub_rn(__fsub_rn(sb, pos), 0.27f);
    float r = fminf(to_mid, may_step_back ? room : 32.0f);
    r = fminf(fmaxf(in_range ? r : 0.0f, 0.0f), 32.0f);  // a NaN gives 0
    return __float2int_rd(r);
  }

  // `len` samples from their sign words; no global access.
  __device__ __forceinline__ void tile(const Consts& k, const uint32_t* sign,
                                       int len, ScanTile& out) {
    int nlist = 0;
    out.list[0] = clock;
    for (int w = 0; w * 32 < len; ++w) {
      const int nbits = min(32, len - w * 32);
      const uint32_t sw = sign[w];
      // bit b: sample b's sign differs from the sample before it
      uint32_t cross = sw ^ ((sw << 1) | last_sign);
      if (nbits < 32) cross &= (1u << nbits) - 1u;
      last_sign = (sw >> (nbits - 1)) & 1u;
      out.base[w] = nlist;
      uint32_t emits = 0, chg = 0;
      int b = 0;
      while (b < nbits) {
        const int stop = cross ? __ffs(cross) - 1 : nbits;
        while (b < stop) {
          // the samples that only advance
          const int quiet = quiet_run();
          const int run = min(quiet, stop - b);
          add_ones(run);
          b += run;
          if (quiet == 32 || b == stop) continue;
          // within a sample or two of an emission or a step back: full
          // steps until one of them has happened
          bool event;
          do {
            event = emit(emits, b);
            event |= advance();
            ++b;
          } while (!event && b < stop);
        }
        if (b >= nbits) break;
        // sample b is a crossing
        cross &= cross - 1u;
        emit(emits, b);
        if (pos > 0.0f && last_b > 0.0f) {
          const float t = ted_walk(__fsub_rn(pos, last_b), clock, k.mx);
          if (t > k.mi08 && t < k.mx12) {
            clock = __fadd_rn(filt.step(k, __fsub_rn(t, k.sps)), k.sps);
            sb = __fmul_rn(10.0f, clock);
            float nm = __fadd_rn(last_b, __fmul_rn(clock, 0.5f));
            while (nm < pos) nm = __fadd_rn(nm, clock);
            next_mid = nm;
            chg |= 1u << b;
            out.list[++nlist] = clock;
          }
        }
        last_b = pos;
        advance();
        ++b;
      }
      out.emit[w] = emits;
      out.chg[w] = chg;
    }
  }
};

// ---- kernel D: the event step over crossing slots

// Loader: the positions of tile `tile` of the slot row into `ev`, and into
// *count its real slots, those before the row's first padding slot
// (position >= n; slots past the row count as padding).  `real` is the
// row's count of real slots where the caller knows it; below 0 the loader
// finds the tile's first padding slot by a ballot.
__device__ __forceinline__ void load_slots(const int* __restrict__ er,
                                           int n_events, int n, int tile,
                                           int real, int* ev, int* count,
                                           int lane) {
  const int i0 = tile * kTile;
  int first = kTile;
#pragma unroll 8
  for (int w = 0; w < kWords; ++w) {
    const int j = w * 32 + lane;
    const int p = i0 + j < n_events ? __ldg(er + i0 + j) : n;
    ev[j] = p;
    if (real < 0) {
      const uint32_t pad = __ballot_sync(0xffffffffu, p >= n);
      if (pad && first == kTile) first = w * 32 + __ffs(pad) - 1;
    }
  }
  if (real >= 0) first = min(max(real - i0, 0), kTile);
  if (lane == 0) *count = first;
}

// The walker of kernel D.  fstate row: [clock, mid_off, bnd_off,
// history...]; istate row: [p_prev, have_boundary, started].
template <int NT>
struct EventsWalker {
  float clock, mid_off, bnd_off;
  int p_prev;
  bool have_b, started;
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

  // event_step over `cnt` real slots; the state after each goes to om / oc.
  // No global access.
  __device__ __forceinline__ void tile(const Consts& k, const int* ev, int cnt,
                                       float* om, float* oc) {
    int p = ev[0];
    for (int j = 0; j < cnt; ++j) {
      const int p_next = ev[min(j + 1, kTile - 1)];
      const int gap_i = p - p_prev;
      const float gap = __int2float_rn(gap_i);
      const float t0_raw = __fadd_rn(gap, bnd_off);
      // both quotients by the old clock, neither waiting for the other
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
      om[j] = mid_off;
      oc[j] = clock;
      p = p_next;
    }
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
