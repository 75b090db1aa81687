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
* the standalone discriminator op (``ops.quad_demod_fast``): kernel C.

Then it times kernel beside plain version, and the AX.25 decode split into
its device front-end and host tail.

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


def time_pair(kernel_fn, plain_fn, plain_ctx, reps: int = 5, calls: int = 10):
    """Median over ``reps`` CUDA-event timings of each, after a warm-up,
    measured in turns; ``plain_fn`` runs inside ``plain_ctx()``.  One
    timing spans ``calls`` back-to-back calls and is divided by that
    count, so the host's launch latency overlaps the device work as it
    does in a stream of calls."""
    def once(fn, ctx):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with ctx():
            s.record()
            for _ in range(calls):
                fn()
            e.record()
            e.synchronize()
        return s.elapsed_time(e) / calls

    once(kernel_fn, contextlib.nullcontext)
    once(plain_fn, plain_ctx)
    k, p = [], []
    for _ in range(reps):
        k.append(once(kernel_fn, contextlib.nullcontext))
        p.append(once(plain_fn, plain_ctx))
    return statistics.median(k), statistics.median(p)


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
                               kernels.quad_demod_fast_plain):
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

    def build_graph():
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(ring_i, ring_q, lpr, DECI,
                                              precision="w3"))
        fir = g.add(blocks.FirFilter(lpr, deci=DECI, precision="w3"), src)
        qd = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=lambda c, x: c + x.sum() + (x * x).sum()),
              qd)
        return g.compile_device_loop(N_MAIN, N_CHUNKS, device=dev)

    loop = build_graph()
    fold = float(next(iter(loop(0).values())))
    launches = dict(kernels.LAUNCHES)
    graph_launches = launches["fm_chain"] - after_models["fm_chain"]
    print(f"[4+5 main path] launches {json.dumps(launches)}; models "
          f"{json.dumps(after_models)}; graph fm_chain launches "
          f"{graph_launches} for {N_CHUNKS} chunks")
    require("FM", launches, ("fir_decimate", "fm_chain"))
    if min(after_models["fir_decimate"], after_models["fm_chain"]) < 2:
        failures.append("the models path launched fewer kernels than it calls")
    if graph_launches != N_CHUNKS:
        failures.append(f"graph launched fm_chain {graph_launches} times")

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

    # ---- 5. the Graph against the same graph on the plain versions
    with plain_versions():
        plain_loop = build_graph()
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

    for precision in ("w3", "i8"):
        pr, pi = packed[precision]

        def run(pr=pr, pi=pi, precision=precision):
            kernels.fm_chain(pr, pi, lpr, DECI, precision=precision, n=N_MAIN)

        timed(f"fm_chain packed {precision} n=2^24", N_MAIN, run, run)
    for taps, deci in [(lpr, 4), (lp1205, 1)]:
        def run(taps=taps, deci=deci):
            kernels.fir_decimate(xg, taps, deci)

        timed(f"fir_decimate {len(taps)} taps deci {deci} n=2^22", N_FIR,
              run, lambda taps=taps, deci=deci:
              kernels.fir_decimate_plain(xg, taps, deci))
    timed(f"graph device loop w3 {N_CHUNKS} x 2^24", N_CHUNKS * N_MAIN,
          lambda: loop(0), lambda: plain_loop(0))
    timed("quad_demod n=2^24", N_MAIN, lambda: ops.quad_demod_fast(xc, GAIN_C),
          lambda: kernels.quad_demod_fast_plain(xc, GAIN_C))
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

    record = {"kernels": [
        {"name": "fir_decimate", "route": "cuda",
         "source": "rustradio_tpu_torch/csrc/fir_decimate.cu",
         "replaces": "rustradio_tpu/ops/pallas_kernels.py:202",
         "launches": (launches["fir_decimate"] + ax_counts["fir_decimate"]
                      + iq_counts["fir_decimate"]),
         "max_abs_err": errs["fir_decimate"],
         "ms": rows["fir_decimate 49 taps deci 4 n=2^22"][0],
         "plain_ms": rows["fir_decimate 49 taps deci 4 n=2^22"][1]},
        {"name": "fm_chain", "route": "cuda",
         "source": "rustradio_tpu_torch/csrc/fm_chain.cu",
         "replaces": "rustradio_tpu/ops/pallas_kernels.py:394,448,553",
         "launches": launches["fm_chain"],
         "max_abs_err": errs["fm_chain"],
         "ms": rows["fm_chain packed w3 n=2^24"][0],
         "plain_ms": rows["fm_chain packed w3 n=2^24"][1]},
        {"name": "quad_demod", "route": "cuda",
         "source": "rustradio_tpu_torch/csrc/quad_demod.cu",
         "replaces": "rustradio_tpu/ops/pallas_kernels.py:91",
         "launches": op_counts["quad_demod"],
         "max_abs_err": errs["quad_demod"],
         "ms": rows["quad_demod n=2^24"][0],
         "plain_ms": rows["quad_demod n=2^24"][1]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
