// The yardstick of kernels D and E (symbol_sync.cu): the same two
// recurrences with ONE THREAD per channel, the port's first form of both
// kernels, kept unchanged so that the block-per-channel design can be timed
// against it on the same card in the same run (tools/time_sync.py,
// chip_smoke.py).  No path of the package calls it.
//
// rr_symbol_sync_scan_lone (kernel E's function) launches one thread per
// block: it reads its row with one 4-byte load per sample, writes one mask
// byte and one clock per sample, and carries the recurrence, all on one
// in-order lane that waits for every load.  rr_symbol_sync_events_lone
// (kernel D's) has one thread walk the real slots from device memory, 15
// predicated filter steps and six predicated timing-error steps per slot
// whatever the tap count, then 128 threads fill the padding tail.  On an
// H100 they take ~200 cycles a sample and ~800 a real slot.
//
// Numerics as in sync_core.cuh, whose constants it shares: every f32
// operation rounded on its own, the order of the JAX scans; bit-equal to
// the plain PyTorch versions.  Built by tools/time_sync.py into a library
// of its own, with chain_calib.cu, not into the package's.

#include <cuda_runtime.h>

#include "sync_core.cuh"

namespace {

using rr::sync::kMaxTaps;

struct SyncConsts : rr::sync::Consts {
  int order;  // ntaps - 1
  int nf;     // floats of filter history kept per channel: max(order, 1)
};

// ret = taps[0]*sample + sum_j taps[j+1]*fbuf[j], in that order, clamped
// to [lo, hi]; the history shifts in ret (newest first) when commit.
__device__ __forceinline__ float clock_filter(const SyncConsts& k,
                                              float (&fbuf)[kMaxTaps - 1],
                                              float sample, bool commit) {
  float ret = __fmul_rn(k.taps[0], sample);
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) {
    if (j < k.order) ret = __fadd_rn(ret, __fmul_rn(k.taps[j + 1], fbuf[j]));
  }
  if (ret < k.lo) ret = k.lo;
  if (ret > k.hi) ret = k.hi;
  if (commit) {
#pragma unroll
    for (int j = kMaxTaps - 2; j > 0; --j) {
      if (j < k.order) fbuf[j] = fbuf[j - 1];
    }
    if (k.order > 0) fbuf[0] = ret;
  }
  return ret;
}

// _ted_reduce (symbol_sync.py:149-167): the closed-form pre-reduction,
// then six predicated steps of the reference's while loop.
__device__ __forceinline__ float ted_reduce(float t0_raw, float clock,
                                            float mx) {
  const float q = floorf(__fdiv_rn(__fsub_rn(t0_raw, mx), clock));
  const float k0 = fmaxf(0.0f, __fsub_rn(q, 1.0f));
  float t = __fsub_rn(t0_raw, __fmul_rn(k0, clock));
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const float t2 = __fsub_rn(t, clock);
    const bool keep = fabsf(__fsub_rn(t, clock)) >= fabsf(__fsub_rn(t2, clock));
    if (t > mx && keep) t = t2;
  }
  return t;
}

// Kernel E.  state row: [clock, last_sign, stream_pos, last_boundary,
// next_mid, fbuf[0..nf)], read at the start and written at the end.
__global__ void symbol_sync_scan_kernel(const float* __restrict__ x,
                                        int channels, long long n,
                                        SyncConsts k, float* __restrict__ state,
                                        int state_len,
                                        unsigned char* __restrict__ mask,
                                        float* __restrict__ clocks) {
  const int c = blockIdx.x;
  if (c >= channels || threadIdx.x != 0) return;
  float* st = state + (long long)c * state_len;
  float clock = st[0];
  bool last_sign = st[1] != 0.0f;
  float pos = st[2], last_b = st[3], next_mid = st[4];
  float fbuf[kMaxTaps - 1];
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) fbuf[j] = j < k.nf ? st[5 + j] : 0.0f;
  const float* xr = x + (long long)c * n;
  unsigned char* mr = mask + (long long)c * n;
  float* cr = clocks + (long long)c * n;
  for (long long i = 0; i < n; ++i) {
    const float sample = xr[i];
    const bool emit = pos >= next_mid;
    mr[i] = emit;
    cr[i] = clock;
    if (emit) next_mid = __fadd_rn(next_mid, clock);
    const bool sign = sample > 0.0f;
    const bool changed = sign != last_sign;
    if (changed && pos > 0.0f && last_b > 0.0f) {
      float t = __fsub_rn(pos, last_b);
      while (t > k.mx) {
        const float t2 = __fsub_rn(t, clock);
        if (fabsf(__fsub_rn(t, clock)) < fabsf(__fsub_rn(t2, clock))) break;
        t = t2;
      }
      if (t > k.mi08 && t < k.mx12) {
        const float ret = clock_filter(k, fbuf, __fsub_rn(t, k.sps), true);
        clock = __fadd_rn(ret, k.sps);
        float nm = __fadd_rn(last_b, __fdiv_rn(clock, 2.0f));
        while (nm < pos) nm = __fadd_rn(nm, clock);
        next_mid = nm;
      }
    }
    if (changed) {
      last_b = pos;
      last_sign = sign;
    }
    pos = __fadd_rn(pos, 1.0f);
    const float sb = __fmul_rn(10.0f, clock);
    if (pos > sb && last_b > sb && next_mid > sb) {
      pos = __fsub_rn(pos, sb);
      last_b = __fsub_rn(last_b, sb);
      next_mid = __fsub_rn(next_mid, sb);
    }
  }
  st[0] = clock;
  st[1] = last_sign ? 1.0f : 0.0f;
  st[2] = pos;
  st[3] = last_b;
  st[4] = next_mid;
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) {
    if (j < k.nf) st[5 + j] = fbuf[j];
  }
}

// Kernel D.  fstate row: [clock, mid_off, bnd_off, fbuf[0..nf)]; istate
// row: [p_prev, have_boundary, started].  Slots hold crossing positions,
// ascending, padded with n; a padding slot leaves the state as it is.  So
// one thread walks a channel's real slots (events_walk) and stops at the
// first padding slot, then the block's threads write the constant state
// into the padding tail: budgets are several times the real crossings, and
// the tail is most of the slots.
constexpr int kEventsThreads = 128;

// event_step over one channel's slots up to its first padding slot,
// prefetching the next slot's position.  Writes ev_mid/ev_clock of the
// real slots and the final state; returns the first padding slot, and the
// final mid offset and clock in mid_out / clock_out.
__device__ int events_walk(const SyncConsts& k, const int* __restrict__ ev,
                           int n_events, int n, float* __restrict__ fs,
                           int* __restrict__ is, float* __restrict__ om,
                           float* __restrict__ oc, float& mid_out,
                           float& clock_out) {
  float clock = fs[0], mid_off = fs[1], bnd_off = fs[2];
  float fbuf[kMaxTaps - 1];
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) fbuf[j] = j < k.nf ? fs[3 + j] : 0.0f;
  int p_prev = is[0];
  bool have_b = is[1] != 0;
  const bool started = is[2] != 0;
  int e = 0;
  int p = n_events > 0 ? ev[0] : n;
  for (; e < n_events && p < n; ++e) {
    const int p_next = e + 1 < n_events ? ev[e + 1] : n;
    const int gap_i = p - p_prev;
    const float gap = __int2float_rn(gap_i);
    // emissions in (p_prev, p] bump mid before the crossing adjusts it
    const int e_unc =
        (int)floorf(__fdiv_rn(__fsub_rn(gap, mid_off), clock)) + 1;
    const int emitted = min(max(e_unc, 0), gap_i);
    const float mid_off_p = __fsub_rn(
        __fadd_rn(mid_off, __fmul_rn(__int2float_rn(emitted), clock)), gap);
    const float t0_raw = __fadd_rn(gap, bnd_off);
    const float t = ted_reduce(t0_raw, clock, k.mx);
    const bool in_range = t > k.mi08 && t < k.mx12;
    const bool past_start = started || p > 0;
    if (past_start && have_b && in_range) {
      const float ret = clock_filter(k, fbuf, __fsub_rn(t, k.sps), true);
      const float new_clock = __fadd_rn(ret, k.sps);
      const float nm0 = __fsub_rn(__fdiv_rn(new_clock, 2.0f), t0_raw);
      const float kk = fmaxf(0.0f, ceilf(__fdiv_rn(-nm0, new_clock)));
      clock = new_clock;
      mid_off = fmaxf(__fadd_rn(nm0, __fmul_rn(kk, new_clock)), 0.0f);
    } else {
      mid_off = mid_off_p;
    }
    p_prev = p;
    bnd_off = 0.0f;
    have_b = past_start;
    om[e] = mid_off;
    oc[e] = clock;
    p = p_next;
  }
  fs[0] = clock;
  fs[1] = mid_off;
  fs[2] = bnd_off;
#pragma unroll
  for (int j = 0; j < kMaxTaps - 1; ++j) {
    if (j < k.nf) fs[3 + j] = fbuf[j];
  }
  is[0] = p_prev;
  is[1] = have_b ? 1 : 0;
  mid_out = mid_off;
  clock_out = clock;
  return e;
}

__global__ void __launch_bounds__(kEventsThreads) symbol_sync_events_kernel(
    const int* __restrict__ events, int channels, int n_events, int n,
    SyncConsts k, float* __restrict__ fstate, int fstate_len,
    int* __restrict__ istate, float* __restrict__ ev_mid,
    float* __restrict__ ev_clock) {
  const int c = blockIdx.x;
  if (c >= channels) return;
  float* om = ev_mid + (long long)c * n_events;
  float* oc = ev_clock + (long long)c * n_events;
  // the walk's end and final state reach the block through shared memory
  __shared__ int s_end;
  __shared__ float s_mid, s_clock;
  if (threadIdx.x == 0) {
    s_end = events_walk(k, events + (long long)c * n_events, n_events, n,
                        fstate + (long long)c * fstate_len,
                        istate + (long long)c * 3, om, oc, s_mid, s_clock);
  }
  __syncthreads();
  for (int e = s_end + threadIdx.x; e < n_events; e += blockDim.x) {
    om[e] = s_mid;
    oc[e] = s_clock;
  }
}

bool make_consts(float sps, float max_dev, const float* taps, int ntaps,
                 SyncConsts* k) {
  if (!rr::sync::make_consts(sps, max_dev, taps, ntaps, k)) return false;
  k->order = ntaps - 1;
  k->nf = rr::sync::history_len(ntaps);
  return true;
}

}  // namespace

// x: (channels, n) f32; state: (channels, state_len) f32, updated in place
// (state_len = 5 + max(ntaps - 1, 1)); mask: (channels, n) bytes 0/1;
// clocks: (channels, n) f32.  taps: ntaps host floats.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rr_symbol_sync_scan_lone(const void* x, int channels, long long n,
                                   float sps, float max_dev, const float* taps,
                                   int ntaps, void* state, int state_len,
                                   void* mask, void* clocks, void* stream) {
  SyncConsts k;
  if (!make_consts(sps, max_dev, taps, ntaps, &k) || state_len != 5 + k.nf)
    return (int)cudaErrorInvalidValue;
  if (channels <= 0) return 0;
  symbol_sync_scan_kernel<<<channels, 1, 0, (cudaStream_t)stream>>>(
      (const float*)x, channels, n, k, (float*)state, state_len,
      (unsigned char*)mask, (float*)clocks);
  return (int)cudaGetLastError();
}

// events: (channels, n_events) int32 crossing positions, ascending, padded
// with n; fstate: (channels, fstate_len) f32 (fstate_len = 3 + max(ntaps -
// 1, 1)) and istate: (channels, 3) int32, both updated in place; ev_mid and
// ev_clock: (channels, n_events) f32, the state after each slot.
extern "C" int rr_symbol_sync_events_lone(const void* events, int channels,
                                     int n_events, int n, float sps,
                                     float max_dev, const float* taps,
                                     int ntaps, void* fstate, int fstate_len,
                                     void* istate, void* ev_mid,
                                     void* ev_clock, void* stream) {
  SyncConsts k;
  if (!make_consts(sps, max_dev, taps, ntaps, &k) || fstate_len != 3 + k.nf)
    return (int)cudaErrorInvalidValue;
  if (channels <= 0) return 0;
  symbol_sync_events_kernel<<<channels, kEventsThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int*)events, channels, n_events, n, k, (float*)fstate,
      fstate_len, (int*)istate, (float*)ev_mid, (float*)ev_clock);
  return (int)cudaGetLastError();
}
