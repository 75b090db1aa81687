// Kernels D and E: clock recovery (zero-crossing TED + clamped IIR clock
// filter, reference src/symbol_sync.rs:115-218), one block per channel.
//
// Neither has a Pallas counterpart.  The JAX package runs both recurrences
// as a lax.scan, vmapped over channels (models/multichannel.py:62-74), which
// XLA compiles into one device program:
//
// * kernel D, rr_symbol_sync_events, replaces the scan over crossing slots
//   of symbol_sync_events (rustradio_tpu/ops/symbol_sync.py:305): event_step
//   (:246-292) over a channel's max_events slots;
// * kernel E, rr_symbol_sync_scan, replaces the per-sample scan of
//   symbol_sync (:145): the step of :87-143, which is also rr_symbol_sync of
//   native/rr_native.cpp:292-369.
//
// What bounds them on an H100 is one lane's dependent chain and its
// control flow, and the design (sync_core.cuh says both at length) keeps
// everything else off that lane: in each block lane 0 of warp 0 walks the
// channel on registers and shared memory only (kernel E from crossing to
// crossing, jumping the samples between; kernel D four slots at a time in
// one stretch with no branch), warp 1 loads the next tile
// (kernel E: reduced to the list of its crossings; kernel D: the slot
// positions and the tile's first padding slot), warps 2-3 write the
// previous tile's results out (kernel E: placing the jumped gaps'
// emissions first), and one __syncthreads() a tile hands the three buffers
// on.  Both kernels equal their plain PyTorch versions (ops/kernels.py) bit
// for bit.

#include <cuda_runtime.h>

#include "sync_core.cuh"

namespace {

using namespace rr::sync;

// Kernel E.  Round t: the walker walks tile t, the loader lists the
// crossings of tile t + 1, the flushers write tile t - 1.  counts, when
// not null, takes each channel's crossings walked and samples stepped one
// by one.
template <int NT>
__global__ void __launch_bounds__(kThreads) symbol_sync_scan_kernel(
    const float* __restrict__ x, long long n, Consts k,
    float* __restrict__ state, int state_len, unsigned char* __restrict__ mask,
    float* __restrict__ clocks, int* __restrict__ counts) {
  __shared__ ScanIn s_in[2];
  __shared__ ScanTile s_out[2];
  static_assert(sizeof(s_in) + sizeof(s_out) <= 48 * 1024,
                "kernel E's static shared memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = (long long)blockIdx.x * n;
  const float* xr = x + row;
  float* st = state + (long long)blockIdx.x * state_len;
  const long long tiles = (n + kTile - 1) / kTile;
  ScanWalker<NT> walker;
  if (tid == 0) walker.load(k, st);
  if (warp == 1) load_crossings(xr, n, 0, st[1] != 0.0f, s_in[0], lane);
  __syncthreads();
  for (long long t = 0; t <= tiles; ++t) {
    const int buf = (int)(t & 1);
    if (warp == 0) {
      if (tid == 0 && t < tiles)
        walker.tile(k, s_in[buf], (int)min((long long)kTile, n - t * kTile),
                    s_out[buf]);
      __syncwarp();
    } else if (warp == 1) {
      if (t + 1 < tiles)
        load_crossings(xr, n, t + 1, false, s_in[buf ^ 1], lane);
    } else if (t > 0) {
      const long long i0 = (t - 1) * kTile;
      flush_scan(s_out[buf ^ 1], (int)min((long long)kTile, n - i0),
                 mask + row + i0, clocks + row + i0, tid - 64);
    }
    __syncthreads();
  }
  if (tid == 0) {
    walker.store(k, st);
    if (counts != nullptr) {
      counts[2 * blockIdx.x] = walker.crossings;
      counts[2 * blockIdx.x + 1] = walker.stepped;
    }
  }
}

// Kernel D.  Slots hold crossing positions, ascending, padded with n; a
// padding slot leaves the state as it is.  So the walker walks a channel's
// real slots only, tile by tile up to the tile that holds the first
// padding slot (round t: walk tile t, load tile t + 1, flush tile t - 1),
// and then the whole block writes the constant final state into the
// padding tail: budgets are several times the real crossings, and the tail
// is most of the slots.  walk, when not null, takes each channel's real
// slots walked and those walked again on the general path.
template <int NT>
__global__ void __launch_bounds__(kThreads) symbol_sync_events_kernel(
    const int* __restrict__ events, const int* __restrict__ counts,
    int n_events, int n, Consts k, float* __restrict__ fstate, int fstate_len,
    int* __restrict__ istate, float* __restrict__ ev_mid,
    float* __restrict__ ev_clock, int* __restrict__ walk) {
  __shared__ int s_ev[2][kTile + kGroup];
  __shared__ float s_mid[2][kTile], s_clk[2][kTile];
  __shared__ int s_cnt[2];
  __shared__ float s_fin[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = (long long)blockIdx.x * n_events;
  const int* er = events + row;
  float* om = ev_mid + row;
  float* oc = ev_clock + row;
  float* fs = fstate + (long long)blockIdx.x * fstate_len;
  int* is = istate + (long long)blockIdx.x * 3;
  const int real = counts ? min(counts[blockIdx.x], n_events) : -1;
  EventsWalker<NT> walker;
  if (tid == 0) walker.load(k, fs, is);
  if (warp == 1)
    load_slots(er, n_events, n, 0, real, s_ev[0], &s_cnt[0], lane);
  __syncthreads();
  int end = 0, prev_cnt = 0;
  bool live = n_events > 0;  // tile t exists and every slot before it is real
  for (int t = 0;; ++t) {
    const int buf = t & 1, i0 = t * kTile;
    int cnt = 0;
    bool next = false;
    if (live) {
      cnt = s_cnt[buf];
      next = cnt == kTile && i0 + kTile < n_events;
      end = i0 + cnt;
    }
    if (warp == 0) {
      if (tid == 0 && cnt > 0)
        walker.tile(k, s_ev[buf], cnt, s_mid[buf], s_clk[buf]);
      __syncwarp();
    } else if (warp == 1) {
      if (next)
        load_slots(er, n_events, n, t + 1, real, s_ev[buf ^ 1],
                   &s_cnt[buf ^ 1], lane);
    } else if (prev_cnt > 0) {
      flush_slots(s_mid[buf ^ 1], s_clk[buf ^ 1], prev_cnt, om + (i0 - kTile),
                  oc + (i0 - kTile), tid - 64);
    }
    __syncthreads();
    if (!live) break;
    prev_cnt = cnt;
    live = next;
  }
  if (tid == 0) {
    walker.store(k, fs, is);
    s_fin[0] = walker.mid_off;
    s_fin[1] = walker.clock;
    if (walk != nullptr) {
      walk[2 * blockIdx.x] = walker.walked;
      walk[2 * blockIdx.x + 1] = walker.general;
    }
  }
  __syncthreads();
  for (int e = end + tid; e < n_events; e += kThreads) {
    om[e] = s_fin[0];
    oc[e] = s_fin[1];
  }
}

// The kernel compiled for the filter's tap count: 1, 2 and 6 taps have
// their own instance, any other count takes the general form.
template <template <int> class Launch, typename... Args>
cudaError_t by_taps(int ntaps, Args... args) {
  switch (ntaps) {
    case 1: Launch<1>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    case 6: Launch<6>::run(args...); break;
    default: Launch<0>::run(args...); break;
  }
  return cudaGetLastError();
}

template <int NT>
struct LaunchScan {
  static void run(int channels, cudaStream_t stream, const float* x,
                  long long n, Consts k, float* state, int state_len,
                  unsigned char* mask, float* clocks, int* counts) {
    symbol_sync_scan_kernel<NT><<<channels, kThreads, 0, stream>>>(
        x, n, k, state, state_len, mask, clocks, counts);
  }
};

template <int NT>
struct LaunchEvents {
  static void run(int channels, cudaStream_t stream, const int* events,
                  const int* counts, int n_events, int n, Consts k,
                  float* fstate, int fstate_len, int* istate, float* ev_mid,
                  float* ev_clock, int* walk) {
    symbol_sync_events_kernel<NT><<<channels, kThreads, 0, stream>>>(
        events, counts, n_events, n, k, fstate, fstate_len, istate, ev_mid,
        ev_clock, walk);
  }
};

}  // namespace

// x: (channels, n) f32; state: (channels, state_len) f32, updated in place
// (state_len = 5 + max(ntaps - 1, 1)); mask: (channels, n) bytes 0/1;
// clocks: (channels, n) f32; counts: (channels, 2) int32, each channel's
// crossings walked and samples stepped one by one, or null.  taps: ntaps
// host floats.  Returns the cudaError_t of the launch (0 on success).
extern "C" int rr_symbol_sync_scan(const void* x, int channels, long long n,
                                   float sps, float max_dev, const float* taps,
                                   int ntaps, void* state, int state_len,
                                   void* mask, void* clocks, void* counts,
                                   void* stream) {
  Consts k;
  if (!make_consts(sps, max_dev, taps, ntaps, &k) ||
      state_len != 5 + history_len(ntaps) || n < 0)
    return (int)cudaErrorInvalidValue;
  if (channels <= 0) return 0;
  return (int)by_taps<LaunchScan>(
      ntaps, channels, (cudaStream_t)stream, (const float*)x, n, k,
      (float*)state, state_len, (unsigned char*)mask, (float*)clocks,
      (int*)counts);
}

// events: (channels, n_events) int32 crossing positions, ascending, padded
// with n; counts: (channels) int32, each row's real slots, or null (the
// loader then finds them); fstate: (channels, fstate_len) f32 (fstate_len
// = 3 + max(ntaps - 1, 1)) and istate: (channels, 3) int32, both updated
// in place; ev_mid and ev_clock: (channels, n_events) f32, the state after
// each slot; walk: (channels, 2) int32, each channel's real slots walked
// and those walked again on the general path, or null.
extern "C" int rr_symbol_sync_events_counted(
    const void* events, const void* counts, int channels, int n_events, int n,
    float sps, float max_dev, const float* taps, int ntaps, void* fstate,
    int fstate_len, void* istate, void* ev_mid, void* ev_clock, void* walk,
    void* stream) {
  Consts k;
  if (!make_consts(sps, max_dev, taps, ntaps, &k) ||
      fstate_len != 3 + history_len(ntaps) || n_events < 0)
    return (int)cudaErrorInvalidValue;
  if (channels <= 0) return 0;
  return (int)by_taps<LaunchEvents>(
      ntaps, channels, (cudaStream_t)stream, (const int*)events,
      (const int*)counts, n_events, n, k, (float*)fstate, fstate_len,
      (int*)istate, (float*)ev_mid, (float*)ev_clock, (int*)walk);
}

// rr_symbol_sync_events_counted without the walk counts.
extern "C" int rr_symbol_sync_events(const void* events, const void* counts,
                                     int channels, int n_events, int n,
                                     float sps, float max_dev,
                                     const float* taps, int ntaps,
                                     void* fstate, int fstate_len,
                                     void* istate, void* ev_mid,
                                     void* ev_clock, void* stream) {
  return rr_symbol_sync_events_counted(events, counts, channels, n_events, n,
                                       sps, max_dev, taps, ntaps, fstate,
                                       fstate_len, istate, ev_mid, ev_clock,
                                       nullptr, stream);
}
