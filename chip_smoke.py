#!/usr/bin/env python3
"""Smoke test of rustradio_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, drives the FM receive
chain's main path at full width (the models entry points and the Graph
device loop over a packed ring), checks the launch counts show that the
path went through the kernels, and times kernel beside plain version.

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
    from rustradio_tpu_torch import blocks, taps as tapgen
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import fm
    from rustradio_tpu_torch.ops import cuda_lib, kernels

    @contextlib.contextmanager
    def plain_versions():
        """Route every kernel call to its plain PyTorch version on the card
        (same inputs, same surrounding code); asserts no kernel launched."""
        before = dict(kernels.LAUNCHES)
        with mock.patch.object(kernels, "fir_decimate",
                               kernels.fir_decimate_plain), \
             mock.patch.object(kernels, "fm_chain_span",
                               kernels.fm_chain_span_plain):
            yield
        if kernels.LAUNCHES != before:
            raise SystemExit("chip_smoke: a plain run launched a kernel")

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
    errs = {"fir_decimate": 0.0, "fm_chain": 0.0}
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
    end_phase("3")

    # ---- 4 + 5. the main path, counted
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
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
    for name, count in launches.items():
        if count == 0:
            failures.append(f"kernel {name} never launched on the main path")
    if min(after_models.values()) < 2:
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

    # ---- 6. times: kernel beside plain version, median of 5 (ms per call)
    rows = {}

    def timed(name, n_in, kernel_fn, plain_fn):
        ms, pms = time_pair(kernel_fn, plain_fn, plain_versions)
        rows[name] = (ms, pms)
        print(f"[6 times] {name}: kernel {ms:.4f} ms ({n_in / ms / 1e3:.1f} "
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

    record = {"kernels": [
        {"name": "fir_decimate", "route": "cuda",
         "source": "rustradio_tpu_torch/csrc/fir_decimate.cu",
         "replaces": "rustradio_tpu/ops/pallas_kernels.py:202",
         "launches": launches["fir_decimate"],
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
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
