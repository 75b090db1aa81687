#!/usr/bin/env python3
"""Smoke test of rustradio_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, and drives three paths at
full width, each with the launch counts set to 0 just before it and read
just after, so that each shows it went through its kernels:

* the FM receive chain (the models entry points and the Graph device loop
  over a packed ring): kernels A and B;
* the AX.25 1200 bd receiver on the 1000-frame decode-rate corpus at
  24 kHz (``ax25_1200_rx``, >= 980 decoded, on the kernels and on the
  plain versions), and on a narrowband-FM IQ capture at 1.024 Msps
  (``ax25_1200_rx_iq``), with each FIR stage of the receiver held
  against its plain version at both rates: kernel A;
* the standalone discriminator op (``ops.quad_demod_fast``): kernel C;
* the clock recovery: kernels D (event-driven) and E (per-sample) held
  against their plain versions (and E against native ``rr_symbol_sync``)
  at bench.py's decode-bank shape, the AX.25 receiver with
  ``sync="events"`` on the corpus, and the wideband multichannel receiver
  (``decode_band_ax25``, 64 channels of a 2.048 Msps capture carrying 8
  stations) with both sync methods: kernels A, D and E, each held again
  against its plain version (E also against native) on the arguments
  that these paths gave it.

Kernels A and B are also held against their plain versions where their
register-blocked design can break (every start residue of the 16-byte
load grid, spans past both ends of a plane, counts around a tile, tap
counts around the register block, large decimations), and the Graph
device loop's CUDA-graph replay against its eager loop (bit-equal folds
at two offsets).

Then it times kernel beside plain version (or native): per call in a
stream of calls, and the device time alone (ten calls replayed from a
captured CUDA graph, inputs rotated so that the L2 cache starts cold),
beside each kernel's bound on this card, the library call where one
computes the same function, and the wrappers' host cost per call; and the
AX.25 decode split into its device front-end and host tail.

    python3 chip_smoke.py        # from the repository root, one GPU

Exits non-zero, printing no result line, when there is no CUDA device or
any phase fails.  The line before the last is the kernels' JSON record;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

DECI = 4
N_MAIN = 1 << 24          # samples per plane on the main path
N_FIR = 1 << 22           # samples for the fir_decimate checks
N_PREFIX = 1 << 18        # prefix held against the float64 model
RING = 4 * N_MAIN         # the Graph's packed ring
N_CHUNKS = 8              # device-loop chunks of N_MAIN (two ring passes)
# the JAX package's own budgets against float64 (tests/test_pallas_interpret.py)
BUDGET = {"highest": 2e-4, "w3": 3e-4, "i8": 3e-4, "w2": 8e-3}
GAIN_C = 0.7              # kernel C's gain, as tests/test_pallas_interpret.py:62
FS_AUDIO = 24_000.0       # the decode-rate corpus (tests/test_decode_rate.py)
N_FRAMES = 1000
FRAME_GATE = 980          # the JAX package's gate on that corpus
TONES_GATE = 900
FS_IQ = 1_024_000.0       # rtl-sdr's rate (apps/rtl_fm.py)
IQ_DEV = 3_000.0          # narrowband FM deviation, Hz
IQ_NOISE = 0.3            # receiver noise per I/Q component; carrier 1.0
N_IQ_FRAMES = 200         # corpus frames carried on the IQ capture
IQ_FLOOR = 196            # of them decoded by ax25_1200_rx_iq
BANK_CH = 64              # bench.py's decode bank (bench.py:223-232):
BANK_N = 1 << 16          # 64 channels x 2^16 NRZ samples at sps 36.75,
BANK_SPS = 36.75          # noise 0.1, default clock taps
BANK_NOISE = 0.1
BANK_EVENTS = 7133        # slot budget, 4 * 2^16 / 36.75
N_SYNC_PREFIX = 1 << 12   # kernel E against its plain per-sample loop
N_SYNC_WINDOW = 2048      # samples (E) or crossings (D) per window held
                          # against the plain loops at a path's own shapes
FS_WB = 2_048_000.0       # the wideband capture: an rtl-sdr rate,
WB_CHANNELS = 64          # 64 channels of 32 kHz (sps 26.7),
WB_STATIONS = (3, 9, 17, 26, 38, 45, 53, 60)  # 8 stations, 4 above M/2,
WB_FRAMES = 25            # 25 corpus frames each (200 frames),
WB_DEV = 3_000.0          # FM at 3 kHz deviation,
WB_NOISE = 0.05           # complex noise per component
WB_FLOOR = 196            # frames of 200 decoded per sync method
PFB_CH, N_PFB = 256, 1 << 22  # bench.py's channelizer row (bench.py:194-209)
# the card's peaks (NVIDIA H100 SXM data sheet): device memory, f32
# outside the tensor cores, and the boost clock the cycle counts below
# are turned into time with
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
SM_HZ = 1.755e9
# the loop-carried dependent chains of csrc/symbol_sync.cu, at 4 cycles per
# dependent f32 operation and 36 per IEEE division.  Kernel D, a real
# slot: gap and t0_raw (3 operations), ted_reduce (1 division, 6
# operations, then 6 steps of 3), the clock filter, clamp and new clock
# (order + 5), the next middle (2 divisions, 7 operations): 39 + order
# operations and 3 divisions.  Kernel E, every sample: the position's add
# and the step-back compare (2); a sample whose crossing is applied adds
# the interval and its tests (2), the filter, clamp and clock (order + 5),
# one division, and the middle's add and compare (2): 9 + order operations
# and 1 division.  The same counts, a division as one operation, are the
# kernels' operations in their bytes-and-operations bound.


def d_slot_ops(order: int) -> tuple[int, int]:
    """(f32 operations, divisions) of one real slot of kernel D."""
    return 39 + order, 3


E_SAMPLE_OPS = 2


def e_crossing_ops(order: int) -> tuple[int, int]:
    """(f32 operations, divisions) that an applied crossing adds in kernel E."""
    return 9 + order, 1


def chain_cycles(ops: int, divisions: int) -> int:
    """Cycles of a dependent chain of these operations."""
    return 4 * ops + 36 * divisions


# outputs from which the FIR core's launcher takes its widest shape (two
# blocks of 1024 outputs per SM)
WIDE = 264 * 1024
SEED = 0
DEVICE = "cuda"

failures: list[str] = []


def report(phase: str, what: str, err: float, tol: float) -> float:
    ok = err <= tol
    print(f"[{phase}] {what}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{phase} {what}")
    return err


def end_phase(phase: str) -> None:
    if failures:
        raise SystemExit(f"chip_smoke: phase {phase} failed: {failures}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        failures.append(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return math.inf
    return float((a.double() - b.double()).abs().max())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rtl_fm_iq(n: int, device, gen: torch.Generator):
    """A wideband FM station as 8-bit rtl-sdr I/Q on the (u8-127)/128 grid:
    two audio tones at 75 kHz deviation, plus receiver noise.  Returns the
    f32 I and Q planes and the f64 phase."""
    fs, dev = 1_024_000.0, 75_000.0
    t = torch.arange(n, dtype=torch.float64, device=device)
    audio = (0.6 * torch.sin(2 * math.pi * 1000.0 / fs * t)
             + 0.3 * torch.sin(2 * math.pi * 3100.0 / fs * t + 0.5))
    phase = torch.cumsum(audio, 0) * (2 * math.pi * dev / fs)
    del t, audio

    def grid(v):
        v = v + 0.02 * torch.randn(n, generator=gen, device=device,
                                   dtype=torch.float64)
        return (torch.round(torch.clamp(v * 128, -127, 128)) / 128).float()

    return grid(0.45 * torch.cos(phase)), grid(0.45 * torch.sin(phase)), phase


def fm_chain_f64(xr: np.ndarray, xi: np.ndarray, taps: np.ndarray, gain=1.0):
    """Float64 numpy model: full-conv FIR, decimate, exact discriminator."""
    def fir(x):
        return np.convolve(x.astype(np.float64), taps.astype(np.float64)
                           )[: len(x)][::DECI]
    y = fir(xr) + 1j * fir(xi)
    d = np.conj(y[:-1]) * y[1:]
    return gain * np.arctan2(d.imag, d.real)


def wrapped_err(a: torch.Tensor, b: torch.Tensor, gain: float) -> float:
    """max |a - b| folded into [-pi|g|, pi|g|): a +-pi branch flip of the
    angle counts as no error."""
    if a.shape != b.shape:
        failures.append(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return math.inf
    g = abs(gain)
    d = torch.remainder(a.double() - b.double() + math.pi * g, 2 * math.pi * g)
    return float((d - math.pi * g).abs().max())


# ---- the AX.25 corpus, built as tests/test_decode_rate.py:23-55 builds it

def corpus_payload(i: int) -> bytes:
    return f"N0CALL-{i%16}>APRS:T#{i:04d} corpus {'y'*(i%29)}".encode()


def corpus_line(i: int, hdlc) -> np.ndarray:
    """Frame i as an NRZI line (transition on 0)."""
    framed = hdlc.hdlc_frame(hdlc.fcs_add(np.frombuffer(corpus_payload(i),
                                                         np.uint8)))
    return (1 + np.cumsum(1 - np.asarray(framed))) % 2


def corpus_drift(i: int) -> float:
    return ((i % 7) - 3) / 3 * 0.015


def afsk(line: np.ndarray, baud: float, amp: float, fs: float,
         lead: int) -> np.ndarray:
    """Bell-202 tones for an NRZI line at ``fs``, between ``lead`` zeros."""
    sps = fs / baud
    n = int(len(line) * sps)
    bit_at = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
    freqs = np.where(line[bit_at] == 1, 1200.0, 2200.0)
    a = (amp * np.sin(np.cumsum(2 * np.pi * freqs / fs))).astype(np.float32)
    z = np.zeros(lead, np.float32)
    return np.concatenate([z, a, z])


def audio_corpus(hdlc) -> np.ndarray:
    """The 1000 frames at 24 kHz: amplitude 0.05-1.0, clock drift
    +-1.5%, noise up to 0.4x amplitude, numpy RandomState(0)."""
    noises = [0.0, 0.15, 0.3, 0.35, 0.4]
    rng = np.random.RandomState(SEED)
    parts = []
    for i in range(N_FRAMES):
        amp = 0.05 + 0.95 * (i % 10) / 9
        x = afsk(corpus_line(i, hdlc), 1200.0 * (1 + corpus_drift(i)), amp,
                 FS_AUDIO, 400)
        parts.append(x + rng.randn(len(x)).astype(np.float32)
                     * (noises[i % 5] * amp))
    return np.concatenate(parts)


def iq_capture(hdlc) -> np.ndarray:
    """The first N_IQ_FRAMES corpus frames as an rtl-sdr capture: full-scale
    Bell-202 audio frequency-modulates a carrier at IQ_DEV deviation,
    sampled at FS_IQ, plus complex receiver noise (numpy default_rng)."""
    lead = int(400 * FS_IQ / FS_AUDIO)  # the corpus' leads, in time
    chunks, ph0 = [], 0.0
    for i in range(N_IQ_FRAMES):
        a = afsk(corpus_line(i, hdlc), 1200.0 * (1 + corpus_drift(i)), 1.0,
                 FS_IQ, lead)
        ph = ph0 + np.cumsum(a, dtype=np.float64) * (2 * np.pi * IQ_DEV / FS_IQ)
        ph0 = float(ph[-1] % (2 * np.pi))
        chunks.append(np.exp(1j * ph).astype(np.complex64))
    iq = np.concatenate(chunks)
    noise = np.random.default_rng(SEED).standard_normal((2, len(iq)),
                                                        dtype=np.float32)
    iq.real += IQ_NOISE * noise[0]
    iq.imag += IQ_NOISE * noise[1]
    return iq


def decoded(packets, n: int) -> list[bytes]:
    """The corpus payloads among the packets, in decode order."""
    want = {corpus_payload(i) for i in range(n)}
    return [bytes(p) for p in packets if bytes(p) in want]


def wideband_capture(hdlc, device, gen: torch.Generator) -> torch.Tensor:
    """WB_FRAMES corpus frames per station, station s carrying frames
    s*WB_FRAMES.., each Bell-202 at its corpus clock drift and full scale
    between the corpus' leads, frequency-modulating a carrier at the center
    of channel WB_STATIONS[s]; summed at FS_WB, plus complex noise.  Made
    on the card (float64 phases)."""
    lead = int(400 * FS_WB / FS_AUDIO)  # the corpus' leads, in time
    z = torch.zeros(lead, dtype=torch.float64, device=device)
    tones = []
    for s in range(len(WB_STATIONS)):
        parts = []
        for i in range(s * WB_FRAMES, (s + 1) * WB_FRAMES):
            line = torch.from_numpy(corpus_line(i, hdlc).astype(np.int64)).to(device)
            sps = FS_WB / (1200.0 * (1 + corpus_drift(i)))
            t = torch.arange(int(len(line) * sps), dtype=torch.float64,
                             device=device)
            bit_at = torch.clamp((t / sps).long(), max=len(line) - 1)
            f = torch.where(line[bit_at] == 1, 1200.0, 2200.0)
            parts += [z, torch.sin(torch.cumsum(2 * math.pi * f / FS_WB, 0)), z]
        tones.append(torch.cat(parts))
    n = max(len(a) for a in tones)
    t = torch.arange(n, dtype=torch.float64, device=device)
    iq = torch.zeros(n, dtype=torch.complex64, device=device)
    for k, a in zip(WB_STATIONS, tones):
        fc = (k if k < WB_CHANNELS / 2 else k - WB_CHANNELS) * FS_WB / WB_CHANNELS
        ph = (torch.cumsum(torch.nn.functional.pad(a, (0, n - len(a))), 0)
              * (2 * math.pi * WB_DEV / FS_WB) + (2 * math.pi * fc / FS_WB) * t)
        iq += torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    noise = WB_NOISE * torch.randn((2, n), generator=gen, device=device)
    return iq + torch.complex(noise[0], noise[1])


def decode_bank(device, gen: torch.Generator) -> torch.Tensor:
    """bench.py's decode-bank input: random bits held for round(sps)
    samples, plus Gaussian noise, (BANK_CH, BANK_N) f32 on the card."""
    rep = int(round(BANK_SPS))
    bits = torch.randint(0, 2, (BANK_CH, BANK_N // rep + 1), generator=gen,
                         device=device) * 2.0 - 1.0
    nrz = torch.repeat_interleave(bits, rep, dim=1)[:, :BANK_N]
    return (nrz + BANK_NOISE * torch.randn(nrz.shape, generator=gen,
                                           device=device)).contiguous()


def wall(fn, reps: int = 3):
    """Median host wall seconds of ``fn()`` between two synchronises, and
    its last result."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def time_pair(kernel_fn, plain_fn, plain_ctx, reps: int = 5, calls: int = 10,
              plain_calls: int | None = None):
    """Median over ``reps`` CUDA-event timings of each, after a warm-up,
    measured in turns; ``plain_fn`` runs inside ``plain_ctx()``.  One
    timing spans ``calls`` back-to-back calls (``plain_calls`` for the
    plain version, default the same) and is divided by that count, so the
    host's launch latency overlaps the device work as it does in a stream
    of calls."""
    plain_calls = calls if plain_calls is None else plain_calls
    event_ms(kernel_fn, contextlib.nullcontext, calls)
    event_ms(plain_fn, plain_ctx, plain_calls)
    k, p = [], []
    for _ in range(reps):
        k.append(event_ms(kernel_fn, contextlib.nullcontext, calls))
        p.append(event_ms(plain_fn, plain_ctx, plain_calls))
    return statistics.median(k), statistics.median(p)


def time_one(fn, reps: int = 5, calls: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``calls`` calls of
    ``fn`` (ms per call), after a warm-up."""
    event_ms(fn, contextlib.nullcontext, calls)
    return statistics.median(event_ms(fn, contextlib.nullcontext, calls)
                             for _ in range(reps))


def event_ms(fn, ctx, calls: int) -> float:
    """CUDA-event ms per call over ``calls`` back-to-back calls of ``fn``
    inside ``ctx()``."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with ctx():
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
    return s.elapsed_time(e) / calls


def graph_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Device ms per call without the host: ``fn(k)`` for k < ``calls``
    captured once into a CUDA graph (after a warm-up on a side stream),
    median over ``reps`` replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            fn(k)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return statistics.median(ts)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call: the wall time of ``calls`` calls with
    no synchronise between them (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over its memory rate and the f32 operations
    over its peak."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fir_bound(n: int, ntaps: int, deci: int, rows: int = 1):
    """Kernel A: n f32 in and ceil(n/deci) out per row, ntaps FMA each."""
    m = -(-n // deci)
    return bound(rows * 4 * (n + m), rows * 2 * m * ntaps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    from rustradio_tpu_torch import blocks, ops, taps as tapgen
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import ax25, fm
    from rustradio_tpu_torch.ops import cuda_lib, hdlc, kernels

    @contextlib.contextmanager
    def plain_versions():
        """Route every kernel call to its plain PyTorch version on the card
        (same inputs, same surrounding code); asserts no kernel launched."""
        before = dict(kernels.LAUNCHES)
        with mock.patch.object(kernels, "fir_decimate",
                               kernels.fir_decimate_plain), \
             mock.patch.object(kernels, "fm_chain_span",
                               kernels.fm_chain_span_plain), \
             mock.patch.object(kernels, "quad_demod_fast",
                               kernels.quad_demod_fast_plain), \
             mock.patch.object(kernels, "symbol_sync_scan",
                               kernels.symbol_sync_scan_plain), \
             mock.patch.object(kernels, "symbol_sync_events_scan",
                               kernels.symbol_sync_events_scan_plain):
            yield
        if kernels.LAUNCHES != before:
            raise SystemExit("chip_smoke: a plain run launched a kernel")

    def zero_counts():
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0

    def stage_err(what: str, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` on the kernels against ``fn(x)`` on the plain versions
        at the FIR budget 2e-5 * max|y|; returns the kernels' output."""
        got = fn(x)
        with plain_versions():
            want = fn(x)
        g, w = (torch.view_as_real(t) if t.is_complex() else t
                for t in (got, want))
        report("6 ax25", f"{what} ({x.shape[0]} samples) vs plain",
               max_err(g, w), 2e-5 * float(w.abs().max()))
        return got

    def front_end_errs(what: str, audio: torch.Tensor, fs: float,
                       tones: bool) -> None:
        """kernel A at the AX.25 receiver's own shapes, on its own data:
        each FIR stage of ``bell202_demod`` (and of the tone demod's
        one-symbol moving average), fed the kernels' input of that stage.
        The stages are held one by one because the exact discriminator
        between them turns a last-ulp difference at a near-zero analytic
        sample into an arbitrary angle."""
        bp = tapgen.band_pass(fs, 400.0, 2700.0, 65, "hamming")
        lp = tapgen.low_pass(fs, 1100.0, 200.0, "hamming")
        x = stage_err(f"{what}: band-pass {len(bp)} taps",
                      lambda a: ops.filter_float(a, bp), audio)
        x = stage_err(f"{what}: Hilbert 65 taps",
                      lambda a: ops.hilbert_transform(a, 65, "hamming"), x)
        stage_err(f"{what}: low-pass {len(lp)} taps",
                  lambda a: ops.filter_float(a, lp),
                  ops.quadrature_demod(x, 1.0))
        if tones:
            w = int(fs / 1200.0)
            avg = np.ones(w, np.float32) / w
            stage_err(f"{what}: tone moving average {w} taps",
                      lambda a: ops.fir_filter_full(a, avg), audio)

    def require(path: str, counts: dict, names) -> None:
        for name in names:
            if counts[name] == 0:
                failures.append(f"kernel {name} never launched on the "
                                f"{path} path")

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 1. environment
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    print(f"[1 env] nvcc: {nvcc}")
    print(f"[1 env] card: {card}")

    # ---- 2. build
    t0 = time.perf_counter()
    cuda_lib.load()
    info = cuda_lib.BUILD_INFO
    print(f"[2 build] {info['path']} cached={info['cached']} "
          f"nvcc_s={info['seconds']:.1f} load_s={time.perf_counter() - t0:.1f}")

    # ---- 3. kernels against their plain versions on the card
    lpr = np.real(tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0,
                                          "hamming")).astype(np.float32)
    lp1205 = tapgen.low_pass(1_024_000.0, 100_000.0, 2048.0)
    if (len(lpr), len(lp1205)) != (49, 1205):
        raise SystemExit(f"chip_smoke: tap sets of {len(lpr)}, {len(lp1205)}")
    errs = {"fir_decimate": 0.0, "fm_chain": 0.0, "quad_demod": 0.0}
    xg = torch.randn(N_FIR, generator=gen, device=dev)
    for taps, deci in [(lpr, 4), (lp1205, 1)]:
        got = kernels.fir_decimate(xg, taps, deci)
        want = kernels.fir_decimate_plain(xg, taps, deci)
        tol = 2e-5 * float(want.abs().max())
        errs["fir_decimate"] = max(errs["fir_decimate"], report(
            "3 kernels", f"fir_decimate {len(taps)} taps deci {deci} n=2^22 f32",
            max_err(got, want), tol))

    i_main, q_main, phase = rtl_fm_iq(N_MAIN, dev, gen)
    pre_want = fm_chain_f64(i_main[:N_PREFIX].cpu().numpy(),
                            q_main[:N_PREFIX].cpu().numpy(), lpr)
    for precision in ("highest", "w3", "i8", "w2"):
        got = kernels.fm_chain(i_main, q_main, lpr, DECI, precision=precision)
        with plain_versions():
            want = kernels.fm_chain(i_main, q_main, lpr, DECI,
                                    precision=precision)
        errs["fm_chain"] = max(errs["fm_chain"], report(
            "3 kernels", f"fm_chain flat {precision} n=2^24",
            max_err(got, want), BUDGET[precision]))
        report("3 kernels", f"fm_chain flat {precision} vs float64 model, "
               "2^18-sample prefix",
               float(np.abs(got[: len(pre_want)].cpu().numpy() - pre_want).max()),
               BUDGET[precision])
    packed = {}
    for precision in ("w3", "i8"):
        pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
        packed[precision] = (pr, pi)
        got = kernels.fm_chain(pr, pi, lpr, DECI, precision=precision, n=n)
        with plain_versions():
            want = kernels.fm_chain(pr, pi, lpr, DECI, precision=precision, n=n)
        errs["fm_chain"] = max(errs["fm_chain"], report(
            "3 kernels", f"fm_chain packed {precision} n=2^24",
            max_err(got, want), BUDGET[precision]))
    pr, pi = packed["w3"]
    half = N_MAIN // DECI // 128 // 1024 // 2  # tiles of 1024 rows per window
    a1, last1 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=half)
    a2, last2 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=half * 1024,
                                        g=half, seed=last1)
    both, last12 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=2 * half)
    # identical arithmetic per sample: the chained windows must reproduce
    # the one-call stream bit for bit, up to 1e-6 stated
    report("3 kernels", "fm_chain_window two chained windows == one call",
           max(max_err(torch.cat([a1, a2]), both), max_err(last2, last12)), 1e-6)
    with plain_versions():
        pa1, plast1 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=half)
    errs["fm_chain"] = max(errs["fm_chain"], report(
        "3 kernels", "fm_chain_window w3 vs plain (audio, last)",
        max(max_err(a1, pa1), max_err(last1, plast1)), BUDGET["w3"]))
    xc = torch.complex(i_main, q_main)  # the station, 2^24 complex64
    got_c = kernels.quad_demod_fast(xc, GAIN_C)
    want_c = kernels.quad_demod_fast_plain(xc, GAIN_C)
    # unfused conjugate product in both; the polynomial's FMA contraction
    # moves a few ulps; a +-pi branch flip is no error (wrapped)
    errs["quad_demod"] = report(
        "3 kernels", f"quad_demod gain {GAIN_C} n=2^24 vs plain (wrapped)",
        wrapped_err(got_c, want_c, GAIN_C), 1e-6 * GAIN_C)
    pre = xc[:N_PREFIX].cpu().numpy().astype(np.complex128)
    pre_want = GAIN_C * np.angle(np.conj(pre[:-1]) * pre[1:])
    report("3 kernels", "quad_demod vs float64 model, 2^18-sample prefix "
           "(wrapped)", wrapped_err(got_c[: N_PREFIX - 1].cpu(),
                                    torch.from_numpy(pre_want), GAIN_C),
           2e-4 * GAIN_C)
    del got_c, want_c
    end_phase("3")

    # ---- 3e. kernels A and B where the register-blocked design can break:
    # one line per group, the case nearest its tolerance
    def worst(what: str, cases) -> float:
        cases = list(cases)
        err, tol = max(cases, key=lambda c: c[0] / c[1])
        report("3 edges", f"{what} ({len(cases)} cases)", err, tol)
        return err

    def slow_planes(n: int, ntaps: int, deci: int, precision: str):
        """Wire-grid I/Q planes of an FM signal slow enough to pass a
        unit-gain ``ntaps`` low-pass at full amplitude, and to turn by at
        most 1 rad per output at ``deci``: no angle comes near +-pi, where
        the last bit of the conjugate product picks the branch."""
        d = min(0.9, 2.0 / ntaps, 1.0 / deci)
        t = torch.arange(n, dtype=torch.float64, device=dev)
        ph = torch.cumsum(d * torch.sin(t * (2e-3 * d)), 0)
        out = []
        for f in (torch.cos, torch.sin):
            v = 0.45 * f(ph) + 0.02 * torch.randn(n, generator=gen, device=dev,
                                                  dtype=torch.float64)
            out.append(kernels.plane_cast(
                (torch.round(torch.clamp(v * 128, -127, 128)) / 128).float(),
                precision))
        return out

    def unit_lp(ntaps: int) -> np.ndarray:
        w = np.hamming(ntaps) if ntaps > 1 else np.ones(1)
        return (w / w.sum()).astype(np.float32)

    def span_case(precision, ntaps, deci, first, count, shift, length):
        """(err, tol) of kernel B's audio and of its last filtered sample
        against the plain version on one span."""
        a, b = slow_planes(length, ntaps, deci, precision)
        kw = dict(first=first, count=count, shift=shift, precision=precision,
                  offset=0.01, seed=(0.3, -0.2))
        got, last = kernels.fm_chain_span(a, b, unit_lp(ntaps), deci, 0.9, **kw)
        want, wlast = kernels.fm_chain_span_plain(a, b, unit_lp(ntaps), deci,
                                                  0.9, **kw)
        return [(max_err(got, want), BUDGET[precision]),
                (max_err(last, wlast), 2e-5)]

    # an input this small gets small tiles of 4 outputs a thread from the
    # launcher; from WIDE outputs on it takes its widest shape (8 outputs a
    # thread, tiles of 1024, and for deci 1, 2 and 4 the staging compiled
    # with deci known), the shape of every full-size call: each case runs at
    # its own count and again with WIDE outputs more
    for extra in (0, WIDE):
        size = f"+{extra} outputs"
        tap_deci = [(1, 1), (7, 1), (9, 1), (3, 4), (5, 4), (49, 4), (49, 3),
                    (1205, 1), (4096, 1), (4096, 50), (1, 50), (49, 50)]
        errs["fm_chain"] = max(
            errs["fm_chain"],
            worst(f"{size}: fm_chain_span: the span starts at every "
                  "residue of the 16-byte grid (f32, bf16, s8)",
                  (c for prec, v in (("highest", 4), ("w3", 8), ("i8", 16))
                   for r in range(v)
                   for c in span_case(prec, 49, DECI, 3, 2500 + extra, -48 + r,
                                      (1 << 15) + DECI * extra))),
            worst(f"{size}: fm_chain_span: taps 1..4096, deci 1, 3, 4, "
                  "50, spans past both ends of the plane (pad 0, -1 for "
                  "s8)",
                  (c for nt, d in tap_deci for prec in ("w3", "i8")
                   for c in span_case(prec, nt, d, 0, 1500 + extra, 1 - nt,
                                      (1500 + extra) * d + nt - 7))),
            worst(f"{size}: fm_chain_span: counts 1, 2 and around a tile "
                  "of 1024 and 2048",
                  (c for cnt in (1, 2, 1023, 1024, 1025, 2047, 2049)
                   for prec in ("w3", "i8")
                   for c in span_case(prec, 49, DECI, 7, cnt + extra, -48,
                                      (1 << 14) + DECI * extra))),
            worst(f"{size}: fm_chain_span: a window that ends at the "
                  "plane's last sample",
                  (c for prec in ("w3", "i8")
                   for c in span_case(prec, 49, DECI, 4096, 4096 + extra, 0,
                                      (4096 + 4096 + extra - 1) * DECI + 49))))

        def fir_cases():
            for nt, d in [(1, 1), (3, 1), (5, 1), (7, 1), (9, 1), (49, 4), (49, 3),
                          (65, 2), (1205, 1), (4096, 1), (4096, 50), (1, 50)]:
                taps = np.random.RandomState(nt + d).randn(nt).astype(np.float32)
                for n in (1, 1023 * 4, 1025 * 4 + 1, (1 << 16) + 3):
                    n += extra * d
                    base = torch.randn(n + 3, generator=gen, device=dev)
                    for off in range(4):  # every residue of the 16-byte grid
                        x = base[off : off + n]
                        want = kernels.fir_decimate_plain(x, taps, d)
                        yield (max_err(kernels.fir_decimate(x, taps, d), want),
                               2e-5 * max(float(want.abs().max()), 1e-3))

        errs["fir_decimate"] = max(errs["fir_decimate"], worst(
            f"{size}: fir_decimate: taps 1..4096, deci 1..50, 1 to 2^16+3 "
            "samples and up, every start residue", fir_cases()))
    xc_edge = torch.complex(torch.randn((1 << 16) + 5, generator=gen, device=dev),
                            torch.randn((1 << 16) + 5, generator=gen, device=dev))
    before_edge = kernels.LAUNCHES["fir_decimate"]
    both_planes = kernels.fir_decimate(xc_edge, lpr, DECI)
    one_launch = kernels.LAUNCHES["fir_decimate"] - before_edge
    each_plane = torch.complex(
        kernels.fir_decimate(xc_edge.real.contiguous(), lpr, DECI),
        kernels.fir_decimate(xc_edge.imag.contiguous(), lpr, DECI))
    report("3 edges", f"fir_decimate complex input, real taps: {one_launch} "
           "launch, against two 1-plane launches",
           max_err(torch.view_as_real(both_planes),
                   torch.view_as_real(each_plane)), 0.0)
    if one_launch != 1:
        failures.append(f"complex input took {one_launch} kernel-A launches")
    null_seed = kernels.fm_chain_span(*packed["w3"], lpr, DECI, first=0,
                                      count=4096, shift=3, precision="w3")
    zero_seed = kernels.fm_chain_span(*packed["w3"], lpr, DECI, first=0,
                                      count=4096, shift=3, precision="w3",
                                      seed=(0.0, 0.0))
    report("3 edges", "fm_chain_span without a seed == with the zero seed",
           max(max_err(null_seed[0], zero_seed[0]),
               max_err(null_seed[1], zero_seed[1])), 0.0)
    del xc_edge, both_planes, each_plane
    end_phase("3 edges")

    # ---- 4 + 5. the FM path, counted
    zero_counts()
    outs = {}
    for precision in ("w3", "i8"):
        pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
        outs[precision] = fm.fm_demod_chain_planar(pr, pi, precision=precision,
                                                   n=n)
    iq = torch.complex(i_main[:N_FIR], q_main[:N_FIR])
    outs["complex"] = fm.fm_demod_chain(iq)
    after_models = dict(kernels.LAUNCHES)

    ring_i, ring_q, _ = rtl_fm_iq(RING, dev, gen)

    def build_graph(cuda_graph=True):
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(ring_i, ring_q, lpr, DECI,
                                              precision="w3"))
        fir = g.add(blocks.FirFilter(lpr, deci=DECI, precision="w3"), src)
        qd = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=lambda c, x: c + x.sum() + (x * x).sum()),
              qd)
        return g.compile_device_loop(N_MAIN, N_CHUNKS, device=dev,
                                     cuda_graph=cuda_graph)

    # the device loop's first call runs the loop once eagerly (its warm-up),
    # captures it into a CUDA graph and replays it; later calls only replay
    loop = build_graph()
    fold_t = next(iter(loop(0).values()))
    fold = float(fold_t)
    launches = dict(kernels.LAUNCHES)
    graph_launches = launches["fm_chain"] - after_models["fm_chain"]
    fold_again = next(iter(loop(0).values()))
    replay_launches = kernels.LAUNCHES["fm_chain"] - launches["fm_chain"]
    print(f"[4+5 main path] launches {json.dumps(launches)}; models "
          f"{json.dumps(after_models)}; graph fm_chain launches "
          f"{graph_launches} for {N_CHUNKS} chunks (warm-up and first replay), "
          f"{replay_launches} for a replay alone")
    require("FM", launches, ("fir_decimate", "fm_chain"))
    if after_models["fir_decimate"] < 1 or after_models["fm_chain"] < 2:
        failures.append("the models path launched fewer kernels than it calls")
    if graph_launches != 2 * N_CHUNKS or replay_launches != N_CHUNKS:
        failures.append(f"graph launched fm_chain {graph_launches} then "
                        f"{replay_launches} times")

    # ---- 4. checks of the models path
    with plain_versions():
        for precision in ("w3", "i8"):
            pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
            want = fm.fm_demod_chain_planar(pr, pi, precision=precision, n=n)
            report("4 models", f"fm_pack_planes + fm_demod_chain_planar "
                   f"{precision} n=2^24 vs plain", max_err(outs[precision], want),
                   BUDGET[precision])
        want = fm.fm_demod_chain(iq)
    # exact atan2 on the filtered stream: f32 rounding amplified at small
    # filtered samples, the chain budget of tests/test_pallas.py (1e-3 rad)
    report("4 models", "fm_demod_chain n=2^22 complex vs plain",
           max_err(outs["complex"], want), 1e-3)
    # the demodulated audio is the station's: output k spans input samples
    # 4k-24 .. 4k+4-24 (the 49-tap filter's 24-sample delay)
    out = outs["w3"]
    k = torch.arange(64, out.shape[0] - 64, device=dev)
    truth = phase[DECI * (k + 1) - 24] - phase[DECI * k - 24]
    corr = float(torch.corrcoef(torch.stack([out[k].double(), truth]))[0, 1])
    finite = all(bool(torch.isfinite(o).all()) for o in outs.values())
    print(f"[4 models] w3 audio vs transmitted frequency: corr={corr:.6f} "
          f"finite={finite} shape={tuple(out.shape)}")
    if not (finite and corr > 0.99 and out.shape[0] == N_MAIN // DECI - 1):
        failures.append("models output")
    end_phase("4")

    # ---- 5. the captured loop against the eager loop (bit-equal folds, at
    # two offsets), then against the same graph on the plain versions
    eager_loop = build_graph(cuda_graph=False)
    for offset0, got_fold in ((0, fold_t), (0, fold_again),
                              (2 * N_MAIN, next(iter(loop(2 * N_MAIN).values())))):
        want_fold = next(iter(eager_loop(offset0).values()))
        report("5 graph", f"CUDA-graph replay == eager loop at offset0 "
               f"{offset0} (fold {float(got_fold)!r})",
               max_err(got_fold, want_fold), 0.0)
    with plain_versions():
        plain_loop = build_graph(cuda_graph=False)
        plain_fold = float(next(iter(plain_loop(0).values())))
    rel = abs(fold - plain_fold) / abs(plain_fold)
    print(f"[5 graph] fold={fold!r} plain_fold={plain_fold!r} rel_err={rel:.3e}")
    # f32 folds of 8 x 4M outputs (sum + sum of squares): rtol 1e-4
    if not (math.isfinite(fold) and rel <= 1e-4):
        failures.append("graph fold")
    end_phase("5")

    # ---- 6. the AX.25 1200 bd path, counted: the corpus at 24 kHz, then an
    # IQ capture at 1.024 Msps
    t0 = time.perf_counter()
    audio = torch.from_numpy(audio_corpus(hdlc)).to(dev)
    print(f"[6 ax25] corpus: {N_FRAMES} frames, {audio.shape[0]} samples at "
          f"{FS_AUDIO:.0f} Hz, synthesized in {time.perf_counter() - t0:.1f} s")
    zero_counts()
    rx_s, rx = wall(lambda: ax25.ax25_1200_rx(audio, FS_AUDIO), reps=1)
    got = decoded(rx, N_FRAMES)
    ax_counts = dict(kernels.LAUNCHES)
    tones = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO, demod="tones"), N_FRAMES)
    tone_counts = dict(kernels.LAUNCHES)
    with plain_versions():
        plain_got = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO), N_FRAMES)
    print(f"[6 ax25] ax25_1200_rx decoded {len(set(got))}/{N_FRAMES} on the "
          f"kernels (first call {rx_s:.3f} s, native build included), "
          f"{len(set(plain_got))}/{N_FRAMES} on the "
          f"plain versions; tones {len(set(tones))}/{N_FRAMES}; launches "
          f"{json.dumps(ax_counts)}, with tones {json.dumps(tone_counts)}")
    require("AX.25", ax_counts, ("fir_decimate",))
    front_end_errs("corpus at 24 kHz", audio, FS_AUDIO, tones=True)
    for what, n, gate in (("kernels", got, FRAME_GATE),
                          ("plain versions", plain_got, FRAME_GATE),
                          ("tones", tones, TONES_GATE)):
        if len(set(n)) < gate:
            failures.append(f"ax25_1200_rx on the {what}: {len(set(n))} < {gate}")

    t0 = time.perf_counter()
    iq_np = iq_capture(hdlc)
    print(f"[6 ax25] IQ capture: {N_IQ_FRAMES} frames, {len(iq_np)} samples at "
          f"{FS_IQ:.0f} Hz, {IQ_DEV:.0f} Hz deviation, noise {IQ_NOISE} per "
          f"component, synthesized in {time.perf_counter() - t0:.1f} s")
    zero_counts()
    iq_s, iq_rx = wall(lambda: ax25.ax25_1200_rx_iq(iq_np, FS_IQ, device=dev),
                       reps=1)
    iq_got = decoded(iq_rx, N_IQ_FRAMES)
    iq_counts = dict(kernels.LAUNCHES)
    with plain_versions():
        iq_plain_s, iq_plain_rx = wall(
            lambda: ax25.ax25_1200_rx_iq(iq_np, FS_IQ, device=dev), reps=1)
    iq_plain = decoded(iq_plain_rx, N_IQ_FRAMES)
    print(f"[6 ax25] ax25_1200_rx_iq decoded {len(set(iq_got))}/{N_IQ_FRAMES} "
          f"on the kernels ({iq_s:.3f} s), {len(set(iq_plain))}/{N_IQ_FRAMES} "
          f"on the plain versions ({iq_plain_s:.3f} s); same list: "
          f"{iq_got == iq_plain}; launches {json.dumps(iq_counts)}; card: {card}")
    require("AX.25 IQ", iq_counts, ("fir_decimate",))
    if iq_got != iq_plain:
        failures.append("ax25_1200_rx_iq: kernels and plain versions decode "
                        "different frames")
    if len(set(iq_got)) < IQ_FLOOR:
        failures.append(f"ax25_1200_rx_iq: {len(set(iq_got))} < {IQ_FLOOR}")
    # the channel filter (FFT route), resampler and discriminator launch no
    # kernel: one IQ front-end output feeds the stages at 50 kHz
    fm_audio = ax25.iq_front_end(iq_np, FS_IQ, device=dev)
    front_end_errs("IQ capture at 50 kHz", fm_audio, 50_000.0, tones=False)
    del iq_np, iq_rx, iq_plain_rx, fm_audio
    end_phase("6")

    # ---- 7. the discriminator op path, counted
    zero_counts()
    out_c = ops.quad_demod_fast(xc, GAIN_C)
    op_counts = dict(kernels.LAUNCHES)
    require("op", op_counts, ("quad_demod",))
    # per-sample receiver noise caps the raw correlation near 0.96; over the
    # FM chain's 4-sample decimation it is the station's audio
    m = (out_c.shape[0] // DECI) * DECI
    mean4 = (out_c[:m].double() / GAIN_C).reshape(-1, DECI).mean(1)
    truth = (phase[1 : m + 1] - phase[:m]).reshape(-1, DECI).mean(1)
    corr = float(torch.corrcoef(torch.stack([mean4, truth]))[0, 1])
    finite = bool(torch.isfinite(out_c).all())
    print(f"[7 op] quad_demod_fast n=2^24: launches {json.dumps(op_counts)}; "
          f"vs transmitted frequency (4-sample means) corr={corr:.6f} "
          f"finite={finite} shape={tuple(out_c.shape)}")
    if not (finite and corr > 0.99 and out_c.shape[0] == N_MAIN - 1):
        failures.append("quad_demod_fast output")
    del out_c
    end_phase("7")

    # ---- 8. times: kernel beside plain version, median of 5 (ms per call)
    rows = {}

    def timed(name, n_in, kernel_fn, plain_fn):
        ms, pms = time_pair(kernel_fn, plain_fn, plain_versions)
        rows[name] = (ms, pms)
        print(f"[8 times] {name}: kernel {ms:.4f} ms ({n_in / ms / 1e3:.1f} "
              f"Msps), plain {pms:.4f} ms ({n_in / pms / 1e3:.1f} Msps); "
              f"card: {card}")

    dev_ms, bounds, lib_ms = {}, {}, {}

    def device_row(name, fn_k, bound_pair, library=None):
        """The device time of ``fn_k(k)`` alone (a replayed CUDA graph of
        ten calls, ``k`` rotating the inputs so that L2 starts cold)
        beside the stream time, the bound and the library call."""
        dev_ms[name], bounds[name] = graph_ms(fn_k), bound_pair
        lib_ms[name] = None
        lib = ""
        if library is not None:
            event_ms(library, kernels._true_f32, 10)
            lib_ms[name] = statistics.median(
                event_ms(library, kernels._true_f32, 10) for _ in range(5))
            lib = f"; library call {lib_ms[name]:.4f} ms"
        stream = f"in a stream {rows[name][0]:.4f} ms; " if name in rows else ""
        print(f"[8 times] {name}: device alone {dev_ms[name]:.4f} ms (10 calls "
              f"replayed from a CUDA graph, median of 5), {stream}bound "
              f"{bound_pair[0]:.4f} ms ({bound_pair[1]}), share of bound "
              f"{bound_pair[0] / dev_ms[name]:.1%}{lib}; card: {card}")

    for precision in ("w3", "i8"):
        pr, pi = packed[precision]
        copies = [(pr, pi)] + [(pr.clone(), pi.clone()) for _ in range(2)]

        def run(k=0, copies=copies, precision=precision):
            a, b = copies[k % len(copies)]
            kernels.fm_chain(a, b, lpr, DECI, precision=precision, n=N_MAIN)

        name = f"fm_chain packed {precision} n=2^24"
        timed(name, N_MAIN, run, run)
        device_row(name, run, bound(
            2 * N_MAIN * pr.element_size() + 4 * (N_MAIN // DECI),
            2 * 2 * (N_MAIN // DECI) * len(lpr)))
        if precision == "w3":
            b_host = (host_us(run), host_us(lambda: kernels.fm_chain(
                pr, pi, kernels.tapset(lpr), DECI, precision="w3", n=N_MAIN)))
        del copies
    xgs = [xg] + [xg.clone() for _ in range(3)]
    for taps, deci in [(lpr, 4), (lp1205, 1)]:
        def run(k=0, taps=taps, deci=deci):
            kernels.fir_decimate(xgs[k % len(xgs)], taps, deci)

        name = f"fir_decimate {len(taps)} taps deci {deci} n=2^22"
        timed(name, N_FIR, run, lambda taps=taps, deci=deci:
              kernels.fir_decimate_plain(xg, taps, deci))
        m = -(-N_FIR // deci)
        padded = torch.nn.functional.pad(
            xg, (len(taps) - 1, m * deci - N_FIR))[None, None]
        w = kernels.tapset(taps).trev("highest", dev)[None, None]
        device_row(name, run, fir_bound(N_FIR, len(taps), deci),
                   library=lambda padded=padded, w=w, deci=deci:
                   torch.nn.functional.conv1d(padded, w, stride=deci))
    a_host = (host_us(lambda: kernels.fir_decimate(xg, lpr, DECI)),
              host_us(lambda: kernels.fir_decimate(xg, kernels.tapset(lpr), DECI)))
    print(f"[8 times] host cost per call, no synchronise between 200 calls: "
          f"kernels.fm_chain packed w3 {b_host[0]:.1f} us with array taps, "
          f"{b_host[1]:.1f} us with a TapSet; kernels.fir_decimate 49 taps "
          f"{a_host[0]:.1f} us with array taps, {a_host[1]:.1f} us with a "
          f"TapSet; card: {card}")
    fft_ms = time_one(lambda: ops.fft_filter_float(xg, lp1205))
    print(f"[8 times] the FFT route at 1205 taps n=2^22 (ops.fft_filter_float, "
          f"torch.fft, no kernel): {fft_ms:.4f} ms beside kernel A's "
          f"{rows['fir_decimate 1205 taps deci 1 n=2^22'][0]:.4f} ms; "
          f"card: {card}")
    del xgs
    name = f"graph device loop w3 {N_CHUNKS} x 2^24"
    timed(name, N_CHUNKS * N_MAIN, lambda: loop(0), lambda: plain_loop(0))
    eager_ms = time_one(lambda: eager_loop(0))
    loop_bound = bound(N_CHUNKS * (2 * N_MAIN * 2 + 4 * (N_MAIN // DECI)), 0.0)
    print(f"[8 times] {name}: CUDA-graph replay {rows[name][0]:.4f} ms, eager "
          f"loop {eager_ms:.4f} ms per loop (each with its final "
          f"synchronise); kernel B's bound for the {N_CHUNKS} chunks "
          f"{loop_bound[0]:.4f} ms; card: {card}")
    timed("quad_demod n=2^24", N_MAIN, lambda: ops.quad_demod_fast(xc, GAIN_C),
          lambda: kernels.quad_demod_fast_plain(xc, GAIN_C))
    device_row("quad_demod n=2^24", lambda k: ops.quad_demod_fast(xc, GAIN_C),
               bound(8 * N_MAIN + 4 * (N_MAIN - 1), 0.0))
    # the AX.25 decode of the corpus: wall time of the whole call, and of
    # its device front-end alone (synchronised); the rest is the host tail
    # (NRZ copy-back, native symbol sync, slicer, NRZI, HDLC)
    for label, ctx in (("kernels", contextlib.nullcontext),
                       ("plain", plain_versions)):
        with ctx():
            total_s, _ = wall(lambda: ax25.ax25_1200_rx(audio, FS_AUDIO))
            front_s, _ = wall(lambda: ax25.bell202_demod(audio, FS_AUDIO))
        print(f"[8 times] ax25_1200_rx {N_FRAMES} frames ({audio.shape[0]} "
              f"samples) on the {label}: {total_s * 1e3:.1f} ms wall, device "
              f"front-end {front_s * 1e3:.1f} ms, host tail "
              f"{(total_s - front_s) * 1e3:.1f} ms (median of 3); card: {card}")

    # the front-end's three kernel-A launches alone, at the corpus' shape
    parts = []
    for label, taps in (
            ("band-pass", tapgen.band_pass(FS_AUDIO, 400.0, 2700.0, 65, "hamming")),
            ("Hilbert", tapgen.hilbert(65, "hamming")),
            ("low-pass", tapgen.low_pass(FS_AUDIO, 1100.0, 200.0, "hamming"))):
        ms = graph_ms(lambda k, taps=taps: kernels.fir_decimate(audio, taps, 1))
        b_ms, by = fir_bound(audio.shape[0], len(taps), 1)
        parts.append(f"{label} {len(taps)} taps {ms:.4f} ms (bound {b_ms:.4f} "
                     f"ms, {by})")
    print(f"[8 times] the AX.25 front-end's kernel-A launches alone on the "
          f"device, {audio.shape[0]} samples: {'; '.join(parts)}; card: {card}")

    # ---- 9. clock recovery (kernels D and E) and the wideband receiver
    from rustradio_tpu_torch import native
    from rustradio_tpu_torch.models import multichannel
    from rustradio_tpu_torch.parallel import channelizer

    @contextlib.contextmanager
    def capturing(*names):
        """Record the arguments of every call of the wrappers
        ``kernels.<name>`` inside the block (the main path's own shapes);
        the calls still go to the wrappers and count their launches."""
        got = {name: [] for name in names}
        with contextlib.ExitStack() as stack:
            for name in names:
                real = getattr(kernels, name)
                stack.enter_context(mock.patch.object(
                    kernels, name, lambda *a, real=real, calls=got[name]:
                    calls.append(a) or real(*a)))
            yield got

    def captured(name: str, fn):
        """Run ``fn()`` and return the arguments of its first call of the
        wrapper ``kernels.<name>``."""
        with capturing(name) as got:
            fn()
        return got[name][0]

    def outputs_equal(what, got, want) -> float:
        """Bit-equality of two wrapper results (tuples of tensors); returns
        the largest |difference| of the f32 outputs (tolerance 0)."""
        err = max(max_err(g, w) for g, w in zip(got, want))
        report("9 sync", what, err, 0.0)
        return err

    def events_check(what, args, window: int | None = None) -> float:
        """Kernel D on a path's own captured arguments against its plain
        version: every output (ev_mid, ev_clock, final fstate and istate).
        The whole call when ``window`` is None (the plain loop stops at the
        last slot holding a crossing); else the first ``window`` slots and
        the slots from ``window`` before the last crossing (of the channel
        with the most) to the end, each run from the state the kernel
        reaches there, and each also held against the whole kernel run
        (so the windows stand for it, positions near n and the padding
        tail included)."""
        events, n, *consts, fs, ist = args
        full = kernels.symbol_sync_events_scan(*args)
        real = int((events < n).sum(1).max())
        print(f"[9 sync] {what}: {events.shape[0]} ch x {events.shape[1]} "
              f"slots, n={n}, at most {real} crossings per channel")
        if window is None or real <= 2 * window:
            return outputs_equal(f"{what}: kernel D whole vs plain", full,
                                 kernels.symbol_sync_events_scan_plain(*args))
        a = real - window
        _, _, fa, ia = kernels.symbol_sync_events_scan(
            events[:, :a].contiguous(), n, *consts, fs, ist)
        errs_ = []
        for label, ev, f0, i0, sl in (
                ("first", events[:, :window], fs, ist, slice(0, window)),
                ("last", events[:, a:], fa, ia, slice(a, None))):
            ev = ev.contiguous()
            got = kernels.symbol_sync_events_scan(ev, n, *consts, f0, i0)
            want = kernels.symbol_sync_events_scan_plain(ev, n, *consts, f0, i0)
            errs_.append(outputs_equal(
                f"{what}: kernel D {label} {window} crossings vs plain", got,
                want))
            whole = (full[0][:, sl], full[1][:, sl])
            if label == "last":
                whole += full[2:]
            errs_.append(outputs_equal(
                f"{what}: kernel D {label} window vs the whole run",
                got[: len(whole)], whole))
        return max(errs_)

    def scan_check(what, args, window: int) -> float:
        """Kernel E on a path's own captured arguments: each channel's
        symbols over the whole call bit-equal to native ``rr_symbol_sync``
        (the path starts from the fresh state native starts from), and the
        first and last ``window`` samples against the plain version, each
        run from the state the kernel reaches there and held against the
        whole kernel run."""
        x, sps, max_dev, taps, st = args
        mask, clocks, st_out = kernels.symbol_sync_scan(*args)
        x_np = x.cpu().numpy()
        unequal = [c for c in range(x.shape[0]) if not np.array_equal(
            x[c][mask[c]].cpu().numpy(),
            native.symbol_sync_f32(x_np[c], sps, max_dev, taps))]
        print(f"[9 sync] {what}: kernel E {x.shape[0]} ch x {x.shape[1]} "
              f"samples vs native: {x.shape[0] - len(unequal)}/{x.shape[0]} "
              f"channels emit the same symbols bit for bit")
        if unequal:
            failures.append(f"{what}: kernel E differs from native on "
                            f"channels {unequal}")
        a = x.shape[1] - window
        _, _, sa = kernels.symbol_sync_scan(x[:, :a].contiguous(), sps,
                                            max_dev, taps, st)
        errs_ = []
        for label, xs, s0, sl in (("first", x[:, :window], st, slice(0, window)),
                                  ("last", x[:, a:], sa, slice(a, None))):
            xs = xs.contiguous()
            got = kernels.symbol_sync_scan(xs, sps, max_dev, taps, s0)
            want = kernels.symbol_sync_scan_plain(xs, sps, max_dev, taps, s0)
            errs_.append(outputs_equal(
                f"{what}: kernel E {label} {window} samples vs plain", got, want))
            whole = (mask[:, sl], clocks[:, sl]) + ((st_out,) if label == "last"
                                                   else ())
            errs_.append(outputs_equal(
                f"{what}: kernel E {label} window vs the whole run",
                got[: len(whole)], whole))
        return max(errs_)

    def sync_equal(what, got, want):
        """Bit-equality of (mask, clocks[, valid]) outputs: report the
        clocks' max |error| (tolerance 0) and count unequal masks."""
        err = max_err(got[1], want[1])
        report("9 sync", f"{what} clocks", err, 0.0)
        for name, a, b in zip(("mask", "valid"), (got[0], *got[2:]),
                              (want[0], *want[2:])):
            if not torch.equal(a, b):
                failures.append(f"{what}: {name} differs from the plain version")
        return err

    bank = decode_bank(dev, gen)
    ev_out, ev_valid = ops.symbol_sync_events(bank, BANK_SPS,
                                              max_events=BANK_EVENTS)
    with plain_versions():
        ev_plain, ev_pvalid = ops.symbol_sync_events(bank, BANK_SPS,
                                                     max_events=BANK_EVENTS)
    errs["symbol_sync_events"] = sync_equal(
        f"kernel D {BANK_CH} x 2^16 sps {BANK_SPS} max_events {BANK_EVENTS}",
        (ev_out[1], ev_out[2], ev_valid), (ev_plain[1], ev_plain[2], ev_pvalid))
    if not bool(ev_valid.all()):
        failures.append("decode bank: a channel overflowed its slot budget")
    (sc_v, sc_m, _), _ = ops.symbol_sync(bank, BANK_SPS)
    bank_np = bank.cpu().numpy()
    unequal = [c for c in range(BANK_CH) if not np.array_equal(
        ops.compact(sc_v[c], sc_m[c]).cpu().numpy(),
        native.symbol_sync_f32(bank_np[c], BANK_SPS, 0.5, (0.5, 0.5)))]
    print(f"[9 sync] kernel E {BANK_CH} x 2^16 vs native rr_symbol_sync: "
          f"{BANK_CH - len(unequal)}/{BANK_CH} channels emit the same symbols "
          f"bit for bit ({int(sc_m.sum())} symbols)")
    if unequal:
        failures.append(f"kernel E differs from native on channels {unequal}")
    prefix = bank[:, :N_SYNC_PREFIX].contiguous()
    (_, pm, pc), pst = ops.symbol_sync(prefix, BANK_SPS)
    with plain_versions():
        (_, qm, qc), qst = ops.symbol_sync(prefix, BANK_SPS)
    errs["symbol_sync_scan"] = sync_equal(
        f"kernel E {BANK_CH} x 2^12 prefix", (pm, pc), (qm, qc))
    report("9 sync", "kernel E 2^12 prefix final state",
           max(max_err(pst[k].float(), qst[k].float()) for k in pst), 0.0)
    end_phase("9 sync")

    # the AX.25 receiver on the corpus with the device clock recovery
    zero_counts()
    with capturing("symbol_sync_events_scan") as ax_calls:
        ev_s, ev_rx = wall(
            lambda: ax25.ax25_1200_rx(audio, FS_AUDIO, sync="events"), reps=1)
    ev_got = decoded(ev_rx, N_FRAMES)
    ev_counts = dict(kernels.LAUNCHES)
    print(f"[9 ax25 events] ax25_1200_rx(sync='events') decoded "
          f"{len(set(ev_got))}/{N_FRAMES} ({ev_s:.3f} s, first call); "
          f"native sync decoded {len(set(got))}; launches "
          f"{json.dumps(ev_counts)}")
    require("AX.25 events", ev_counts, ("fir_decimate", "symbol_sync_events"))
    if len(set(ev_got)) < FRAME_GATE:
        failures.append(f"ax25_1200_rx(sync='events'): {len(set(ev_got))} < "
                        f"{FRAME_GATE}")
    # the kernels' arguments on each path, checked here and timed below
    path_args = {"kernel D, AX.25 events path":
                 ax_calls["symbol_sync_events_scan"][0]}
    errs["symbol_sync_events"] = max(errs["symbol_sync_events"], events_check(
        "AX.25 events path", path_args["kernel D, AX.25 events path"],
        window=N_SYNC_WINDOW))
    del ax_calls
    end_phase("9 ax25 events")

    # the wideband receiver at full width, both sync methods
    t0 = time.perf_counter()
    wide = wideband_capture(hdlc, dev, gen)
    torch.cuda.synchronize()
    print(f"[9 wideband] capture: {len(WB_STATIONS)} stations on channels "
          f"{list(WB_STATIONS)} of {WB_CHANNELS}, {len(WB_STATIONS) * WB_FRAMES} "
          f"frames, {wide.shape[0]} samples at {FS_WB:.0f} Hz "
          f"({wide.shape[0] / FS_WB:.1f} s), noise {WB_NOISE} per component, "
          f"synthesized on the card in {time.perf_counter() - t0:.1f} s")
    want_wb = {(WB_STATIONS[i // WB_FRAMES], corpus_payload(i))
               for i in range(len(WB_STATIONS) * WB_FRAMES)}
    wb_counts, wb_first = {}, {}

    def wideband(method):
        return multichannel.decode_band_ax25(
            wide, FS_WB, n_channels=WB_CHANNELS, max_active=len(WB_STATIONS),
            sync_method=method)

    for method in ("scan", "events"):
        zero_counts()
        with capturing("symbol_sync_scan", "symbol_sync_events_scan") as calls:
            wb_first[method], res = wall(lambda: wideband(method), reps=1)
        wb_counts[method] = dict(kernels.LAUNCHES)
        found = {(r.channel, bytes(p)) for r in res for p in r.packets}
        ok = len(found & want_wb)
        chans = sorted(r.channel for r in res)
        print(f"[9 wideband] decode_band_ax25 sync {method}: {ok}/{len(want_wb)} "
              f"frames on their channels, channels decoded {chans}, "
              f"{sum(len(r.packets) for r in res)} packets "
              f"({wb_first[method]:.3f} s, first call); launches "
              f"{json.dumps(wb_counts[method])}")
        require(f"wideband {method}", wb_counts[method],
                ("fir_decimate", f"symbol_sync_{method}"))
        if chans != sorted(WB_STATIONS):
            failures.append(f"wideband {method}: channels {chans} decoded")
        if ok < WB_FLOOR:
            failures.append(f"wideband {method}: {ok} < {WB_FLOOR} frames")
        # the kernels at the shapes this path gave them (E also re-runs
        # the channels that overflowed their event budget)
        for args in calls["symbol_sync_events_scan"][:1]:
            path_args[f"kernel D, wideband {method}"] = args
            errs["symbol_sync_events"] = max(errs["symbol_sync_events"],
                                             events_check(f"wideband {method}",
                                                          args))
        for args in calls["symbol_sync_scan"][:1]:
            path_args[f"kernel E, wideband {method}"] = args
            errs["symbol_sync_scan"] = max(errs["symbol_sync_scan"], scan_check(
                f"wideband {method}", args, N_SYNC_WINDOW))
        del calls
    end_phase("9 wideband")

    # times, median of 5 (ms per call); the card beside each
    def timed9(name, ms, pms, other="plain"):
        rows[name] = (ms, pms)
        print(f"[9 times] {name}: kernel {ms:.4f} ms, {other} {pms:.4f} ms; "
              f"card: {card}")

    pfb_x = torch.complex(torch.randn(N_PFB, generator=gen, device=dev),
                          torch.randn(N_PFB, generator=gen, device=dev))
    pfb_taps = channelizer.channelizer_taps(PFB_CH)
    pfb_ms = time_one(lambda: channelizer.pfb_channelize(pfb_x, pfb_taps, PFB_CH))
    print(f"[9 times] pfb_channelize {PFB_CH} channels x 2^22 (plain torch + "
          f"cuFFT, no kernel): {pfb_ms:.4f} ms ({N_PFB / pfb_ms / 1e3:.1f} "
          f"Msps); card: {card}")
    del pfb_x
    def chain_d(args):
        """Kernel D's dependent-chain bound (ms) on these arguments: the
        busiest channel's real slots times the cycles of one."""
        events, n, _, _, clock_taps = args[:5]
        real = int((events < n).sum(1).max())
        cycles = chain_cycles(*d_slot_ops(len(clock_taps) - 1))
        return real * cycles / SM_HZ * 1e3, f"{real} real slots x {cycles} cycles"

    def ops_d(args) -> float:
        """Kernel D's f32 operations on these arguments: every channel's
        real slots times the operations of one."""
        events, n, _, _, clock_taps = args[:5]
        return float(int((events < n).sum()) * sum(d_slot_ops(len(clock_taps) - 1)))

    def crossings_e(x):
        """Sign changes per channel: kernel E's applied crossings at most."""
        sign = x > 0
        return (sign[:, 1:] != sign[:, :-1]).sum(1)

    def chain_e(args):
        """Kernel E's: every sample, plus the busiest channel's sign
        changes as applied crossings."""
        x, _, _, clock_taps = args[:4]
        crossings = int(crossings_e(x).max())
        per_sample = chain_cycles(E_SAMPLE_OPS, 0)
        cycles = chain_cycles(*e_crossing_ops(len(clock_taps) - 1))
        return ((x.shape[1] * per_sample + crossings * cycles) / SM_HZ * 1e3,
                f"{x.shape[1]} samples x {per_sample} cycles + {crossings} "
                f"crossings x {cycles}")

    def ops_e(args) -> float:
        x, _, _, clock_taps = args[:4]
        return float(x.numel() * E_SAMPLE_OPS + int(crossings_e(x).sum())
                     * sum(e_crossing_ops(len(clock_taps) - 1)))

    chains = {}  # row -> (ms, what): kernels D and E, beside their bound

    def chain_line(name, ms, chain):
        chains[name] = chain
        print(f"[9 times] {name}: dependent-chain bound {chain[0]:.4f} ms "
              f"({chain[1]} at {SM_HZ / 1e9:.3f} GHz), share of it "
              f"{chain[0] / ms:.1%}; card: {card}")

    d_args = captured("symbol_sync_events_scan", lambda: ops.symbol_sync_events(
        bank, BANK_SPS, max_events=BANK_EVENTS))
    d_name = f"kernel D {BANK_CH} x {BANK_EVENTS} slots"
    timed9(d_name, *time_pair(
        lambda: kernels.symbol_sync_events_scan(*d_args),
        lambda: kernels.symbol_sync_events_scan_plain(*d_args),
        contextlib.nullcontext, plain_calls=1))
    # events in, both per-slot outputs out; the counted operations
    device_row(d_name, lambda k: kernels.symbol_sync_events_scan(*d_args), bound(
        12 * d_args[0].numel(), ops_d(d_args)))
    chain_line(d_name, dev_ms[d_name], chain_d(d_args))
    op_ms, op_pms = time_pair(
        lambda: ops.symbol_sync_events(bank, BANK_SPS, max_events=BANK_EVENTS),
        lambda: ops.symbol_sync_events(bank, BANK_SPS, max_events=BANK_EVENTS),
        plain_versions, plain_calls=1)
    print(f"[9 times] symbol_sync_events op {BANK_CH} x 2^16 (crossing list, "
          f"kernel D, mask pass): {op_ms:.4f} ms "
          f"({BANK_CH * BANK_N / op_ms / 1e3:.1f} Msps), on the plain versions "
          f"{op_pms:.4f} ms; card: {card}")
    e_args = captured("symbol_sync_scan", lambda: ops.symbol_sync(bank, BANK_SPS))

    def native_bank():
        for c in range(BANK_CH):
            native.symbol_sync_f32(bank_np[c], BANK_SPS, 0.5, (0.5, 0.5))

    nat_s = statistics.median(
        [wall(native_bank, reps=1)[0] for _ in range(5)])
    e_ms = time_one(lambda: kernels.symbol_sync_scan(*e_args), calls=3)
    timed9(f"kernel E {BANK_CH} x 2^16", e_ms, nat_s * 1e3,
           f"native rr_symbol_sync on the host, {BANK_CH} channels in turn,")
    chain_line(f"kernel E {BANK_CH} x 2^16", e_ms, chain_e(e_args))
    p_args = captured("symbol_sync_scan", lambda: ops.symbol_sync(prefix, BANK_SPS))
    e_name = f"kernel E {BANK_CH} x 2^12 prefix"
    timed9(e_name, *time_pair(
        lambda: kernels.symbol_sync_scan(*p_args),
        lambda: kernels.symbol_sync_scan_plain(*p_args),
        contextlib.nullcontext, plain_calls=1))
    # samples in, a mask byte and a clock out; the counted operations
    device_row(e_name, lambda k: kernels.symbol_sync_scan(*p_args), bound(
        9 * p_args[0].numel(), ops_e(p_args)))
    chain_line(e_name, dev_ms[e_name], chain_e(p_args))
    for name, args in path_args.items():
        is_d = name.startswith("kernel D")
        fn = kernels.symbol_sync_events_scan if is_d else kernels.symbol_sync_scan
        ms = time_one(lambda: fn(*args), calls=3)
        print(f"[9 times] {name}, the path's own arguments "
              f"({args[0].shape[0]} x {args[0].shape[1]}): kernel {ms:.4f} ms; "
              f"card: {card}")
        chain_line(name, ms, (chain_d if is_d else chain_e)(args))
    front_s, _ = wall(lambda: ax25.bell202_demod(audio, FS_AUDIO))
    for sync in ("native", "events"):
        total_s, _ = wall(lambda: ax25.ax25_1200_rx(audio, FS_AUDIO, sync=sync))
        print(f"[9 times] ax25_1200_rx sync={sync} {N_FRAMES} frames: "
              f"{total_s * 1e3:.1f} ms wall, device front-end "
              f"{front_s * 1e3:.1f} ms, clock recovery and tail "
              f"{(total_s - front_s) * 1e3:.1f} ms (median of 3); card: {card}")
    for method in ("scan", "events"):
        wb_s, _ = wall(lambda: wideband(method))
        print(f"[9 times] decode_band_ax25 sync {method}, {wide.shape[0]} "
              f"samples: {wb_s * 1e3:.1f} ms wall (median of 3; first call "
              f"{wb_first[method] * 1e3:.1f} ms); card: {card}")

    def entry(name, source, replaces, n_launches, row):
        """One kernel of the record: its launches on its paths, its error
        against the plain version, its time in a stream of calls (``ms``)
        and alone on the device, the plain version's, the bound computed
        from this run's inputs (bytes over the memory rate or operations
        over the f32 peak), and the library call's where one exists.  One
        thread per channel (kernels D and E) is held by neither: its entry
        also has ``chain_bound_ms``, the dependent chain of the busiest
        channel counted from the source, and what it was counted from."""
        out = {"name": name, "route": "cuda",
               "source": f"rustradio_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": n_launches,
               "max_abs_err": errs[name], "ms": rows[row][0],
               "plain_ms": rows[row][1], "device_ms": dev_ms[row],
               "bound_ms": bounds[row][0], "bound_by": bounds[row][1],
               "library_ms": lib_ms[row]}
        if row in chains:
            out["chain_bound_ms"], out["chain"] = chains[row]
        return out

    record = {"kernels": [
        entry("fir_decimate", "fir_decimate.cu",
              "rustradio_tpu/ops/pallas_kernels.py:202",
              launches["fir_decimate"] + ax_counts["fir_decimate"]
              + iq_counts["fir_decimate"],
              "fir_decimate 49 taps deci 4 n=2^22"),
        entry("fm_chain", "fm_chain.cu",
              "rustradio_tpu/ops/pallas_kernels.py:394,448,553",
              launches["fm_chain"], "fm_chain packed w3 n=2^24"),
        entry("quad_demod", "quad_demod.cu",
              "rustradio_tpu/ops/pallas_kernels.py:91",
              op_counts["quad_demod"], "quad_demod n=2^24"),
        entry("symbol_sync_events", "symbol_sync.cu",
              "rustradio_tpu/ops/symbol_sync.py:305",
              ev_counts["symbol_sync_events"]
              + wb_counts["events"]["symbol_sync_events"], d_name),
        entry("symbol_sync_scan", "symbol_sync.cu",
              "rustradio_tpu/ops/symbol_sync.py:145",
              wb_counts["scan"]["symbol_sync_scan"], e_name),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
