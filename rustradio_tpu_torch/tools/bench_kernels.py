"""The port's micro-benchmarks (counterpart of ``benches/bench_kernels.py``):
one JSON line a row, under the JAX row's own ``bench`` name, each row at
the JAX script's accelerator size and checked for correctness before it is
timed.

    python -m rustradio_tpu_torch.tools.bench_kernels [--only fm_chain,fir]
        [--seed 0] [--trace]                     # on the card
    python -m rustradio_tpu_torch.tools.bench_kernels --device cpu --small

Groups (``--only``, the JAX script's names): fm_chain, native, bell202,
fir, fft_filter, quad_demod, channelizer, decode_bank, scan_stream,
scan_stream_device; and three the JAX script has no row for: recurrences,
kernels F and G; band_clock, kernel E alone at the wideband cell's shape
and clock (with its ``kernels.SCAN_COUNTS`` per channel and its cycles a
sample); and ax25_clock, kernel D alone at the AX.25 cell's shape (with
its ``kernels.EVENTS_COUNTS`` and its cycles a real slot).  Inputs come
from ``--seed`` (torch.Generator on the device, numpy for the host rows).

Method.  A device row's time is the median of 5 CUDA-event timings of 10
back-to-back calls after 2 warm-up calls, with the quartiles and the
count (``ms``, ``ms_q1``, ``ms_q3``, ``samples``); calls rotate among
inputs made beforehand, or vary kernel B's ``offset``
as the JAX rows vary theirs, so that no elementwise pass joins the timed
window.  Host rows (``native_*``, the streams' whole runs) take the host
clock ended by ``torch.cuda.synchronize()``.  Where a kernel carries the
row, the line also has ``device_ms`` (the kernel's calls of one row call
alone, replayed from a CUDA graph), ``host_us`` a call, ``launches`` a
call, ``bound_ms`` / ``bound_by`` (``utils.stats.bound_ms`` of the
``kernels.*_work`` count at the row's shapes and mode, never read from the
kernel) and ``gbps`` / ``roofline_pct`` (the counted bytes over the row's
time, against the card's memory rate).  ``--trace`` adds one
``torch.profiler`` window of 3 calls a row, outside the timed runs: the
device's busy share and device ms a call by kernel name.

Every line names the card (``torch.cuda.get_device_name``, and
``nvidia-smi``'s power limit, and its SM clock read right after the row's
timings) and says ``correct``: the
row's checks (``checks``: what, error, tolerance) against float64 models,
native code or the plain versions.  A failed check prints
``"correct": false`` and the program exits 1 after the last row; a row that
raises stops the run.  Without a card the program exits 1 unless given
``--device cpu``: the plain versions, every time field null (no CPU number
is printed under a device metric's name), the checks still made.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import sys
import tempfile
import time
import typing
from unittest import mock

import numpy as np
import torch

from . import corpus, timing

DECI = corpus.DECI
# the JAX package's budgets against float64 (tests/test_pallas_interpret.py;
# split3 the ~3e-3 rad of rustradio_tpu/ops/pallas_kernels.py:847)
BUDGET = {"highest": 2e-4, "w3": 3e-4, "i8": 3e-4, "w2": 8e-3, "split3": 3e-3}
FIR_TOL = 2e-5             # of max|y|, the FIR rows against float64
QUAD_TOL = 1e-6            # of |gain|, kernel C against its plain version
QUAD_F64_TOL = 2e-4        # of |gain|, kernel C against float64 (fast atan2)
CALLS = 10                 # calls a timing
REPS = 5                   # timings a row
BANK_SPS = corpus.BANK_SPS
FS_BELL = 44_100.0         # bench_bell202_frontend's rate
PFB_CH = 256               # the channelizer's channels
CELL_CH = 128              # and the wideband cell's (aprs_wideband.scan)
POWER_TOL = 1e-5           # relative, kernel H's channel power against plain
CMA_TAPS, CMA_MU = corpus.CMA_TAPS, corpus.CMA_MU
STREAM_GAIN = 0.5          # the streams' MultiplyConst
PLANE_BYTES = {"highest": 4, "split3": 4, "w3": 2, "w2": 2, "i8": 1}
# the leaf wrapper that launches each kernel (a kernels.LAUNCHES key)
LEAF = {"fir_decimate": "_fir_planes", "fm_chain": "fm_chain_span",
        "quad_demod": "quad_demod_fast",
        "symbol_sync_events": "symbol_sync_events_scan",
        "symbol_sync_scan": "symbol_sync_scan",
        "pfb_channelize": "pfb_channelize", "cma": "cma_scan", "iir": "iir_scan"}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The rows' sizes: the JAX script's accelerator sizes by default;
    ``SMALL`` (``--small``) keeps every row at 2^16 samples or fewer."""

    fm_n: int = 1 << 24        # bench_fm_chain, bench.py's headline
    fir_n: int = 1 << 23       # bench_fir
    fft_n: int = 1 << 23       # bench_fft_filter
    quad_n: int = 1 << 23      # bench_quad_demod
    chan_n: int = 1 << 22      # bench_channelizer (256 channels)
    cell_n: int = 1 << 28      # the channelizer at the wideband cell's shape
    bell_n: int = 1 << 22      # bench_bell202_frontend
    bank_ch: int = 64          # bench_decode_bank
    bank_n: int = 1 << 16
    band_ch: int = corpus.BAND_CH   # band_clock: the wideband cell's bank
    band_n: int = corpus.BAND_N
    aprs_n: int = corpus.APRS_N     # ax25_clock: the AX.25 cell's capture
    stream_chunk: int = 1 << 18   # bench_scan_stream
    device_chunk: int = 1 << 20   # bench_scan_stream_device
    stream_chunks: int = 64
    native_n: int = 1 << 22    # bench_native
    hdlc_frames: int = 64
    hdlc_repeats: int = 8
    loop_n: int = 1 << 24      # bench.py's Graph device loop: its chunk,
    loop_chunks: int = 8       # its chunks a call (a ring of 4 chunks)
    tile_rows: int = 1024      # and its packed ring's tile rows
    prefix: int = 1 << 18      # samples held against float64 models
    sync_prefix: int = 1 << 12  # native symbol sync against the plain loop
    recur_window: int = 1 << 14  # kernels F and G: the window held bit for bit,
    cma_call: int = 1 << 22    # F's windows at the main path's call,
    iir_call: int = 1 << 24    # G's samples at the main path's stream


SMALL = Sizes(fm_n=1 << 16, fir_n=1 << 16, fft_n=1 << 16, quad_n=1 << 16,
              chan_n=1 << 16, cell_n=1 << 16, bell_n=1 << 16, bank_ch=4,
              bank_n=1 << 11, band_n=1 << 13, stream_chunk=1 << 13, device_chunk=1 << 13,
              stream_chunks=8, native_n=1 << 16, hdlc_frames=8, hdlc_repeats=2,
              aprs_n=1 << 16, loop_n=1 << 14, loop_chunks=4, tile_rows=32,
              prefix=1 << 14,
              sync_prefix=1 << 10, recur_window=1 << 8, cma_call=1 << 10,
              iir_call=1 << 14)


@dataclasses.dataclass
class Ctx:
    """What every row is made from: the device, the sizes, the seed, the
    card (None on the CPU) and whether to trace."""

    device: torch.device
    sizes: Sizes
    seed: int = 0
    card: timing.Card | None = None
    trace: bool = False

    def gen(self, salt: int) -> torch.Generator:
        """A generator on the device, seeded from the seed and ``salt``."""
        return torch.Generator(device=self.device).manual_seed(
            self.seed * 1000 + salt)

    def rng(self, salt: int) -> np.random.RandomState:
        return np.random.RandomState(self.seed * 1000 + salt)


@dataclasses.dataclass
class Row:
    """One benchmark row.  ``runs`` maps a variant's name to one call on
    input rotation k (the first variant is the row's time); ``check``
    returns {what: (error, tolerance)}; ``kernel`` is the kernel that
    carries the row, ``work`` its (bytes, f32 operations) at the row's
    shapes, ``record(k)`` what the kernel's calls are recorded from
    (default the first variant); ``host`` rows take the host clock;
    ``rate`` names the row's ``n`` a microsecond (the JAX row's key);
    ``derive(line)`` gives fields computed from the measured line."""

    bench: str
    n: int
    runs: dict
    check: typing.Callable[[], dict]
    kernel: str | None = None
    work: tuple | None = None
    record: typing.Callable | None = None
    rotation: int = 1
    host: bool = False
    fields: dict = dataclasses.field(default_factory=dict)
    rate: str = "msps"
    derive: typing.Callable[[dict], dict] | None = None


def wrapped(a: torch.Tensor, b, gain: float = 1.0) -> float:
    """max |a - b| folded into [-pi|g|, pi|g|) (a +-pi branch flip of an
    angle is no error); b may be numpy; inf for unequal shapes."""
    b = torch.as_tensor(b, device=a.device)
    if a.shape != b.shape:
        return math.inf
    g = abs(gain)
    d = torch.remainder(a.double() - b.double() + math.pi * g, 2 * math.pi * g)
    return float((d - math.pi * g).abs().max()) if d.numel() else 0.0


def abs_err(a: torch.Tensor, b) -> float:
    b = torch.as_tensor(b, device=a.device)
    if a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def fm_windows_f64(a: torch.Tensor, b: torch.Tensor, taps, n_win: int):
    """The float64 model of the FM chain (decimation ``DECI``) over the
    first and the last ``n_win`` samples of the planes ``a``, ``b``:
    [(first output index, outputs)], the last window read with its
    filter's history."""
    h = -(-(len(taps) - 1) // DECI) * DECI       # history, whole output steps
    n = a.shape[0]
    s0 = max(n - n_win, 0) // DECI * DECI
    out = [(0, corpus.fm_chain_f64(a[:n_win].cpu().numpy(),
                                   b[:n_win].cpu().numpy(), taps))]
    lo = max(s0 - h, 0)
    tail = corpus.fm_chain_f64(a[lo:].cpu().numpy(), b[lo:].cpu().numpy(), taps)
    return out + [(s0 // DECI, tail[(s0 - lo) // DECI:])]


def fir_check(got: torch.Tensor, x: torch.Tensor, taps, deci: int,
              prefix: int) -> tuple:
    """(error, tolerance) of a FIR output against the float64 model on the
    first ``prefix`` input samples: FIR_TOL of the model's max|y|."""
    want = corpus.fir_deci_f64(x[:prefix].cpu().numpy(), np.asarray(taps), deci)
    return abs_err(got[: len(want)], want), FIR_TOL * float(np.abs(want).max())


def recorded(fn, kernel: str):
    """The calls of ``kernel``'s leaf wrapper (``LEAF``) made by ``fn()``:
    [(wrapper, args, kwargs)]; the calls still run."""
    from ..ops import kernels

    name = LEAF[kernel]
    real = getattr(kernels, name)
    calls = []

    def spy(*a, **kw):
        calls.append((real, a, kw))
        return real(*a, **kw)

    with mock.patch.object(kernels, name, spy):
        fn()
    return calls


# ---------------------------------------------------------------- rows

def fm_chain_rows(ctx: Ctx, precisions=("w3", "i8", "highest", "split3", "w2"),
                  pack: bool = True):
    """bench_fm_chain: kernel B on packed planes of wire-grid noise, packed
    once outside the timed calls (``fm_plane_pack``), each call at its own
    ``offset`` (bench_kernels.py:108-150); and the ingest pack itself."""
    from ..ops import kernels

    s, n = ctx.sizes, ctx.sizes.fm_n
    lp = kernels.tapset(corpus.fm_taps())
    a, b = corpus.wire_noise((2, n), ctx.device, ctx.gen(1)).unbind(0)
    a, b = a.contiguous(), b.contiguous()
    windows = fm_windows_f64(a, b, lp, s.prefix)
    m = -(-n // DECI)
    for prec in precisions:
        pa = kernels.fm_plane_pack(a, lp, DECI, precision=prec)
        pb = kernels.fm_plane_pack(b, lp, DECI, precision=prec)

        def run(k, pa=pa, pb=pb, prec=prec):
            return kernels.fm_chain(pa, pb, lp, DECI, 1.0, offset=1e-3 * k / 16,
                                    precision=prec, n=n)

        def check(run=run, prec=prec):
            got = run(0)
            return {f"float64 model, {what} {s.prefix} samples (wrapped)":
                    (wrapped(got[i0: i0 + len(want)], want), BUDGET[prec])
                    for what, (i0, want) in zip(("first", "last"), windows)}

        yield Row(f"fm_chain/{prec}", n, {"": run}, check, kernel="fm_chain",
                  work=kernels.fm_chain_work(m, len(lp), DECI, PLANE_BYTES[prec]),
                  rotation=16, fields={"deci": DECI, "ntaps": len(lp),
                                       "precision": prec})
        del pa, pb
    if not pack:
        return
    planes = [a, b, a.flip(0).contiguous()]
    geo = kernels.fm_pack_geometry(n, lp, DECI)

    def pack_run(k):
        return kernels.fm_plane_pack(planes[k % 3], lp, DECI, precision="w3")

    def pack_check():
        got = pack_run(0)
        lo = geo.wlen - 1
        pad = torch.cat([got[:lo], got[lo + n:]]).float()
        return {"packed samples == the plane": (abs_err(got[lo: lo + n], a), 0.0),
                "padding zero": (float(pad.abs().max()) if pad.numel() else 0.0, 0.0)}

    yield Row("fm_ingest_pack", n, {"": pack_run}, pack_check, rotation=3)


FIR_SHAPES = ((1, 49), (4, 49), (1, 1205), (4, 1205))  # (deci, taps)


def fir_taps(deci: int, ntaps: int) -> np.ndarray:
    """bench_fir's taps: the low-pass at 400 kHz / deci, cycled to
    ``ntaps`` and scaled by 1 / ntaps (bench_kernels.py:155-158)."""
    from .. import taps as tapgen

    taps = np.real(tapgen.low_pass_complex(1_024_000.0, 400_000.0 / deci,
                                           50_000.0, "hamming"))
    return np.resize(taps.astype(np.float32), ntaps) / ntaps


def fir_rows(ctx: Ctx):
    """bench_fir: kernel A at deci 1 / 4 and 49 / 1205 taps over noise."""
    from ..ops import kernels

    s, n = ctx.sizes, ctx.sizes.fir_n
    gen = ctx.gen(2)
    xs = [torch.randn(n, generator=gen, device=ctx.device) for _ in range(4)]
    for deci, ntaps in FIR_SHAPES:
        taps = kernels.tapset(fir_taps(deci, ntaps))

        def run(k, taps=taps, deci=deci):
            return kernels.fir_decimate(xs[k % len(xs)], taps, deci)

        def check(run=run, taps=taps, deci=deci):
            return {"float64 model, prefix": fir_check(run(0), xs[0], taps, deci,
                                                       s.prefix)}

        yield Row(f"fir_banded/deci{deci}_taps{ntaps}", n, {"": run}, check,
                  kernel="fir_decimate", work=kernels.fir_work(n, ntaps, deci),
                  rotation=len(xs), fields={"deci": deci, "ntaps": ntaps})


def complex_noise(ctx: Ctx, n: int, salt: int, count: int = 3):
    gen = ctx.gen(salt)
    return [torch.complex(torch.randn(n, generator=gen, device=ctx.device),
                          torch.randn(n, generator=gen, device=ctx.device))
            for _ in range(count)]


def fft_filter_rows(ctx: Ctx):
    """bench_fft_filter: the complex 49-tap low-pass, deci 4, by overlap-save
    FFTs of 8192 (torch.fft; no kernel)."""
    from .. import taps as tapgen
    from ..ops.fft_filter import fft_filter_decimate

    s, n = ctx.sizes, ctx.sizes.fft_n
    lp = np.asarray(tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0,
                                            "hamming"))
    xs = complex_noise(ctx, n, 3)

    def run(k):
        return fft_filter_decimate(xs[k % len(xs)], lp, DECI, fft_size=8192)

    def check():
        got = run(0)
        x = xs[0][: s.prefix].cpu().numpy()

        def fir(v, t):
            return corpus.fir_deci_f64(v, t, DECI)

        tr, ti = np.real(lp), np.imag(lp)
        want = (fir(x.real, tr) - fir(x.imag, ti)
                + 1j * (fir(x.real, ti) + fir(x.imag, tr)))
        g = got[: len(want)]
        err = abs_err(torch.view_as_real(g), np.stack([want.real, want.imag], -1))
        return {"float64 model, prefix": (err, FIR_TOL * float(np.abs(want).max()))}

    yield Row("fft_filter_decimate", n, {"": run}, check, rotation=len(xs))


def quad_demod_rows(ctx: Ctx):
    """bench_quad_demod: kernel C (``ops.quad_demod_fast``) over noise."""
    from .. import ops
    from ..ops import kernels

    s, n = ctx.sizes, ctx.sizes.quad_n
    xs = complex_noise(ctx, n, 4)

    def run(k):
        return ops.quad_demod_fast(xs[k % len(xs)], 1.0)

    def check():
        got = run(0)
        pre = xs[0][: s.prefix].cpu().numpy().astype(np.complex128)
        want = np.angle(np.conj(pre[:-1]) * pre[1:])
        return {"plain version (wrapped)":
                (wrapped(got, kernels.quad_demod_fast_plain(xs[0], 1.0)), QUAD_TOL),
                "float64 model, prefix (wrapped)":
                (wrapped(got[: len(want)], want), QUAD_F64_TOL)}

    yield Row("quad_demod", n, {"": run}, check, kernel="quad_demod",
              work=kernels.quad_work(n), rotation=len(xs))


def pfb_f64(x: np.ndarray, taps: np.ndarray, m: int, frames: int) -> np.ndarray:
    """Float64 model of the critically sampled polyphase channelizer's
    first ``frames`` frames: y[i, k] = sum_m e^{2 pi i k m / M}
    sum_l h[l M + m] x[(i - l) M - m], zero history."""
    h = np.asarray(taps, np.float64).reshape(-1, m)
    xp = np.concatenate([np.zeros(m - 1), x[: frames * m].astype(np.complex128)])
    f = xp[: frames * m].reshape(frames, m)[:, ::-1]     # f[i, m] = x[i M - m]
    v = np.zeros((frames, m), np.complex128)
    for lag in range(h.shape[0]):
        v[lag:] += h[lag] * f[: frames - lag]
    return np.fft.ifft(v, axis=1) * m


def channelizer_rows(ctx: Ctx, cell: bool = True):
    """bench_channelizer: kernel H (``kernels.pfb_channelize`` with the
    channels' power, as the wideband receiver calls it) beside its plain
    version, 256 channels; with ``cell``, also at the wideband cell's shape
    (``aprs_wideband.scan``: 128 channels, 8 taps a branch)."""
    from ..ops import kernels
    from ..parallel.channelizer import channelizer_taps

    s = ctx.sizes
    shapes = [(PFB_CH, s.chan_n, 5)] + ([(CELL_CH, s.cell_n, 6)] if cell else [])
    for m, size, salt in shapes:
        n = size - size % m
        taps = channelizer_taps(m)
        xs = complex_noise(ctx, n, salt)

        def run(k, xs=xs, taps=taps, m=m):
            return kernels.pfb_channelize(xs[k % len(xs)], taps, m, power=True)

        def plain(k, xs=xs, taps=taps, m=m):
            ch = kernels.pfb_channelize_plain(xs[k % len(xs)], taps, m)
            return ch, kernels.pfb_power_plain(ch)

        def check(run=run, plain=plain, xs=xs, taps=taps, m=m, n=n):
            frames = min(s.prefix, n) // m
            want = pfb_f64(xs[0].cpu().numpy(), taps, m, frames)
            (got, power), (pch, ppower) = run(0), plain(0)
            return {"float64 model, prefix frames": (
                abs_err(torch.view_as_real(got[:frames]),
                        np.stack([want.real, want.imag], -1)),
                FIR_TOL * float(np.abs(want).max())),
                "plain version, power (relative)": (
                    float(((power - ppower).abs() / ppower).max()), POWER_TOL)}

        yield Row(f"channelizer/{m}ch", n, {"": run, "plain": plain}, check,
                  kernel="pfb_channelize", work=kernels.pfb_work(n, m, len(taps) // m),
                  rotation=len(xs), fields={"channels": m,
                                            "taps_per_branch": len(taps) // m})
        del xs


def bell202_taps(fs: float):
    """The three FIR stages of ``bell202_demod`` at its defaults."""
    from .. import taps as tapgen

    return (tapgen.band_pass(fs, 400.0, 2700.0, 65, "hamming"),
            tapgen.hilbert(65, "hamming"),
            tapgen.low_pass(fs, 1100.0, 200.0, "hamming"))


def bell202_rows(ctx: Ctx):
    """bench_bell202_frontend: band-pass, Hilbert, discriminator and audio
    low-pass over noise at 44.1 kHz (kernel A three times a call)."""
    from ..models.ax25 import bell202_demod
    from ..ops import kernels

    s, n = ctx.sizes, ctx.sizes.bell_n
    gen = ctx.gen(6)
    xs = [torch.randn(n, generator=gen, device=ctx.device) for _ in range(3)]

    def run(k):
        return bell202_demod(xs[k % len(xs)], FS_BELL)

    def check():
        out = {}
        calls = recorded(lambda: run(0), "fir_decimate")
        for i, (fn, (x, taps, deci), _) in enumerate(calls):
            out[f"kernel A call {i} ({len(taps)} taps), float64 model, prefix"] = (
                fir_check(fn(x, taps, deci), x, taps, deci, s.prefix))
        out["kernel A calls"] = (abs(len(calls) - 3), 0)
        return out

    work = [sum(w) for w in zip(*(kernels.fir_work(n, len(t), 1)
                                  for t in bell202_taps(FS_BELL)))]
    yield Row("bell202_frontend", n, {"": run}, check, kernel="fir_decimate",
              work=tuple(work), rotation=len(xs))


def crossings(x: torch.Tensor) -> torch.Tensor:
    """Sign changes of each row (each a crossing the clock recovery sees)."""
    sign = x > 0
    return (sign[:, 1:] != sign[:, :-1]).sum(1)


def decode_bank_rows(ctx: Ctx, methods=("scan", "events")):
    """bench_decode_bank: the clock recovery of 64 channels of noisy NRZ
    (``recover_symbols_batch``), per sample (kernel E) and over the
    crossings (kernel D)."""
    from .. import native
    from ..models.multichannel import recover_symbols_batch
    from ..ops import kernels
    from ..ops.symbol_sync import compact

    s = ctx.sizes
    ch, per = s.bank_ch, s.bank_n
    gen = ctx.gen(7)
    banks = [corpus.decode_bank(ctx.device, gen, ch, per) for _ in range(3)]
    rep = int(round(BANK_SPS))
    budget = max(1024, 4 * per // rep)   # bench_kernels.py:265
    cross = crossings(banks[0])
    for method in methods:
        kw = {"max_events": budget} if method == "events" else {}

        def run(k, method=method, kw=kw):
            return recover_symbols_batch(banks[k % len(banks)], BANK_SPS, 0.5,
                                         (0.5, 0.5), method=method,
                                         return_valid=True, **kw)

        if method == "scan":
            def check(run=run):
                vals, mask, _, _ = run(0)
                x = banks[0].cpu().numpy()
                unequal = sum(not np.array_equal(
                    compact(vals[c], mask[c]).cpu().numpy(),
                    native.symbol_sync_f32(x[c], BANK_SPS, 0.5, (0.5, 0.5)))
                    for c in range(ch))
                return {"channels unequal to native rr_symbol_sync": (unequal, 0)}

            work = kernels.scan_work(ch * per, BANK_SPS, int(cross.sum()), 1)
            name, kernel = "decode_bank", "symbol_sync_scan"
        else:
            def check(run=run):
                _, mask, clocks, valid = run(0)
                with timing.plain_versions():
                    _, pmask, pclocks, pvalid = run(0)
                return {"clocks vs plain version": (abs_err(clocks, pclocks), 0.0),
                        "masks unequal to the plain version":
                        (int((mask != pmask).sum()), 0),
                        "channels over the slot budget":
                        (int((~valid).sum()) + int((valid != pvalid).sum()), 0)}

            work = kernels.events_work(ch * budget,
                                       int(cross.clamp(max=budget).sum()), 1)
            name, kernel = "decode_bank_events", "symbol_sync_events"
        yield Row(f"{name}/{ch}ch", ch * per, {"": run}, check, kernel=kernel,
                  work=work, rotation=len(banks),
                  fields={"nch": ch, "unroll": 16, "slots": budget
                          if method == "events" else None})


def band_clock_rows(ctx: Ctx):
    """Kernel E alone at the wideband cell's shape and clock (8 x 2^21,
    sps 2.56e6 / 128 / 1200, six taps of 1/6, deviation 0.5) on
    ``corpus.band_nrz``, from the fresh state: each channel against native
    ``rr_symbol_sync`` (its symbols, their clocks, the final state) and,
    on the first ``sync_prefix`` samples, bit for bit against the plain
    version; ``kernels.SCAN_COUNTS`` per channel (crossings a sample, the
    share of samples stepped one by one) and the cycles a sample of the
    device time at the row's SM clock."""
    from .. import native
    from ..ops import kernels

    s = ctx.sizes
    ch, n, sps, taps = s.band_ch, s.band_n, corpus.BAND_SPS, corpus.BAND_TAPS
    gen, rng = ctx.gen(11), ctx.rng(11)
    banks = [corpus.band_nrz(ctx.device, gen, rng, ch, n) for _ in range(3)]
    k = kernels.sync_consts(sps, 0.5, taps)
    state = torch.tensor([k.sps, 0.0, 0.0, 0.0, k.sps / 2] + [k.sps] * k.nf,
                         dtype=torch.float32, device=ctx.device)
    state = state.expand(ch, -1).contiguous()
    counts = {}

    def run(j, x=None):
        return kernels.symbol_sync_scan(banks[j % len(banks)] if x is None
                                        else x, sps, 0.5, taps, state)

    def check():
        mask, clocks, out = run(0)
        got = kernels.SCAN_COUNTS
        if got is not None and ctx.card is not None:
            counts["cross"], counts["stepped"] = (got.cpu().double() / n).T.tolist()
        x, m, c, o = (t.cpu().numpy() for t in (banks[0], mask, clocks, out))
        unequal = 0
        for r in range(ch):
            sym, clk, fin = native.symbol_sync_f32_state(x[r], sps, 0.5, taps)
            row = np.array([fin["clock"], float(fin["last_sign"]),
                            fin["stream_pos"], fin["last_sym_boundary_pos"],
                            fin["next_sym_middle"], *fin["fbuf"]], np.float32)
            unequal += not (np.array_equal(x[r][m[r]], sym)
                            and np.array_equal(c[r][m[r]], clk)
                            and np.array_equal(o[r], row))
        p = min(s.sync_prefix, n)
        head = banks[0][:, :p].contiguous()
        plain = kernels.symbol_sync_scan_plain(head.cpu(), sps, 0.5, taps,
                                               state.cpu())
        differ = sum(not torch.equal(g.cpu(), w)
                     for g, w in zip(run(0, head), plain))
        return {"channels unequal to native rr_symbol_sync": (unequal, 0),
                f"outputs unequal to the plain version (first {p})": (differ, 0)}

    def derive(line):
        cyc = None
        if line.get("device_ms") is not None and line.get("sm_clock_mhz"):
            cyc = line["device_ms"] * 1e3 * line["sm_clock_mhz"] / n
        return {"cycles_per_sample": cyc,
                "crossings_per_sample": counts.get("cross"),
                "stepped_share": counts.get("stepped")}

    cross = int(crossings(banks[0]).sum())
    yield Row(f"band_clock/{ch}ch", ch * n, {"": run}, check,
              kernel="symbol_sync_scan",
              work=kernels.scan_work(ch * n, sps, cross, len(taps) - 1),
              rotation=len(banks), derive=derive,
              fields={"nch": ch, "sps": sps, "taps": len(taps)})


def ax25_clock_rows(ctx: Ctx):
    """Kernel D alone at the AX.25 cell's shape (aprs1200.events): one
    channel of Bell 202 front-end output at 44.1 kHz (``corpus.aprs_audio``
    through ``models.ax25.bell202_demod``, 2^24 samples), the cell's slot
    budget (``default_max_events``), six taps of 1/6, deviation 0.5, from
    the fresh state; bit for bit against the plain version (every slot's
    outputs and the final state, the plain loop over every real slot);
    ``kernels.EVENTS_COUNTS`` (the real slots, the share walked again on
    the general path) and the cycles a real slot of the device time at the
    row's SM clock."""
    import importlib

    from ..models import ax25
    from ..ops import kernels

    tss = importlib.import_module("..ops.symbol_sync", __package__)
    sps, taps = corpus.APRS_SPS, corpus.APRS_TAPS
    audio = torch.from_numpy(corpus.aprs_audio(ctx.rng(12), ctx.sizes.aprs_n))
    nrz = ax25.bell202_demod(audio.to(ctx.device), corpus.APRS_FS)[None]
    n = nrz.shape[1]
    budget = tss.default_max_events(n, sps)
    sign = nrz > 0.0
    changed = torch.cat([sign[:, :1], sign[:, 1:] != sign[:, :-1]], 1)
    events = tss._crossings(changed, budget)
    real = changed.sum(1, dtype=torch.int32).clamp(max=budget)
    k = kernels.sync_consts(sps, 0.5, taps)
    mid0 = float(np.float32(k.sps) / np.float32(2.0) + np.float32(1.0))
    fstate = torch.tensor([[k.sps, mid0, 1.0] + [k.sps] * k.nf], device=ctx.device)
    istate = torch.tensor([[-1, 0, 0]], dtype=torch.int32, device=ctx.device)
    args = (events, n, sps, 0.5, taps, fstate, istate, real)
    counts = {}

    def run(j):
        return kernels.symbol_sync_events_scan(*args)

    def check():
        got = run(0)
        walk = kernels.EVENTS_COUNTS
        if walk is not None and ctx.card is not None:
            walked, general = walk[0].tolist()
            counts.update(real=walked, general=general / max(walked, 1))
        want = kernels.symbol_sync_events_scan_plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in args))
        slots = sum(int((g.cpu() != w).sum()) for g, w in zip(got[:2], want[:2]))
        final = sum(not torch.equal(g.cpu(), w) for g, w in zip(got[2:], want[2:]))
        return {f"slots unequal to the plain version (all {budget})": (slots, 0),
                "final states unequal to the plain version's": (final, 0)}

    def derive(line):
        cyc = None
        if line.get("device_ms") is not None and line.get("sm_clock_mhz") \
                and counts.get("real"):
            cyc = line["device_ms"] * 1e3 * line["sm_clock_mhz"] / counts["real"]
        return {"cycles_per_real_slot": cyc, "real_slots": counts.get("real"),
                "general_share": counts.get("general")}

    yield Row("ax25_clock/1ch", n, {"": run}, check, kernel="symbol_sync_events",
              work=kernels.events_work(budget, int(real.sum()), len(taps) - 1),
              derive=derive, fields={"nch": 1, "sps": sps, "taps": len(taps),
                                     "slots": budget})


def device_sink(keep: bool = False):
    """A device-domain sink that keeps the last chunk (with ``keep``, every
    chunk: ``data()``) and takes a ``scan_chunks`` batch in one call."""
    from ..blocks.base import Block

    class DeviceSink(Block):
        graph_capturable = False  # a sink
        n_out = 0
        domain = "device"

        def __init__(self):
            self.parts, self.last = [], None

        def apply(self, x):
            self.last = x
            if keep:
                self.parts.append(x)
            return ()

        def accept_batch(self, stacked):
            self.last = stacked[-1]
            if keep:
                self.parts.append(stacked.reshape(-1))

        def data(self):
            return torch.cat(self.parts)

    return DeviceSink()


def stream_rows(ctx: Ctx, resident: bool):
    """bench_scan_stream (host data to a host sink) and
    bench_scan_stream_device (device-resident data to a device sink):
    FirFilter (49 taps) -> QuadratureDemod -> MultiplyConst over real noise
    through ``Graph.run_stream``, per chunk and with ``scan_chunks`` the
    whole stream (kernel B once a chunk); whole runs on the host clock."""
    from .. import blocks
    from ..graph import Graph
    from ..ops import kernels

    s = ctx.sizes
    chunk = s.device_chunk if resident else s.stream_chunk
    n_chunks = s.stream_chunks
    n = chunk * n_chunks
    taps = corpus.fm_taps()
    if resident:
        data = torch.randn(n, generator=ctx.gen(8), device=ctx.device)
    else:
        data = ctx.rng(9).randn(n).astype(np.float32)

    def graph(sink):
        g = Graph()
        g.chain(blocks.VectorSource(data), blocks.FirFilter(taps),
                blocks.QuadratureDemod(1.0), blocks.MultiplyConst(STREAM_GAIN),
                sink)
        return g

    def runner(scan):
        g = graph(device_sink() if resident else blocks.NullSink())

        def run(k):
            g.run_stream(chunk_size=chunk, scan_chunks=scan, device=ctx.device)
        return run

    def out(scan=None, offline=False):
        sink = device_sink(keep=True) if resident else blocks.VectorSink()
        g = graph(sink)
        if offline:
            g.run(device=ctx.device)
        else:
            g.run_stream(chunk_size=chunk, scan_chunks=scan, device=ctx.device)
        return torch.as_tensor(sink.data()).to(ctx.device)

    def check():
        whole = out(offline=True)
        return {"per chunk == offline Graph.run": (abs_err(out(), whole), 0.0),
                f"scan_chunks={n_chunks} == offline Graph.run":
                (abs_err(out(n_chunks), whole), 0.0)}

    # outputs: n - len(taps) + 1 from the valid chain, one fewer from the
    # discriminator; kernel B reads f32 planes ("highest")
    name = "scan_stream_device" if resident else "scan_stream"
    yield Row(name, n, {"scan": runner(n_chunks), "per_chunk": runner(None)},
              check, kernel="fm_chain",
              work=kernels.fm_chain_work(n - len(taps) + 1, len(taps), 1, 4),
              record=lambda k: out(), host=True,
              fields={"chunk": chunk, "n_chunks": n_chunks})


def native_rows(ctx: Ctx):
    """bench_native: the host C++ tail (native/rr_native.cpp), symbol sync
    and HDLC deframing, on the host clock."""
    from .. import native, ops

    s = ctx.sizes
    native.load()
    rng = ctx.rng(10)
    n = s.native_n
    bits = rng.randint(0, 2, int(n / BANK_SPS) + 2) * 2.0 - 1.0
    x = np.repeat(bits, int(round(BANK_SPS)))[:n].astype(np.float32)
    x += rng.randn(n).astype(np.float32) * 0.1
    taps = np.asarray([0.5, 0.5])

    def sync_run(k):
        return native.symbol_sync_f32(x, BANK_SPS, 0.5, taps)

    def sync_check():
        p = x[: s.sync_prefix]
        (vals, mask, _), _ = ops.symbol_sync(torch.from_numpy(p)[None], BANK_SPS)
        plain = ops.compact(vals[0], mask[0]).numpy()
        got = native.symbol_sync_f32(p, BANK_SPS, 0.5, taps)
        return {"prefix vs the plain per-sample loop, unequal symbols":
                (math.inf if got.shape != plain.shape
                 else int((got != plain).sum()), 0)}

    yield Row("native_symbol_sync", n, {"": sync_run}, sync_check, host=True)

    frames = [np.asarray(ops.hdlc_frame(ops.fcs_add(
        rng.randint(0, 256, 256).astype(np.uint8))))
        for _ in range(s.hdlc_frames)]
    stream = np.concatenate(frames * s.hdlc_repeats).astype(np.uint8)

    def hdlc_run(k):
        return native.HdlcDeframer(1, 1500, False, False).feed(stream)

    def hdlc_check():
        want = s.hdlc_frames * s.hdlc_repeats
        return {f"frames found of {want}": (abs(len(hdlc_run(0)) - want), 0)}

    yield Row("native_hdlc_deframe", len(stream), {"": hdlc_run}, hdlc_check,
              host=True, fields={"bits": len(stream)}, rate="mbps")


def cma_rows(ctx: Ctx):
    """Kernel F (``ops.cma_equalize``, 16 taps) on ``corpus.cma_channel``
    of the main path's station, as chip_smoke's phase 14 feeds it: over
    the held window and at the main path's call.  Its first
    ``recur_window`` windows are held bit-equal to the plain version (a
    Python loop over the windows: the whole call only at the window) and
    to the float64 recurrence (numpy on the host)."""
    from .. import ops
    from ..ops import kernels

    s = ctx.sizes
    t0 = torch.zeros(CMA_TAPS, dtype=torch.complex64, device=ctx.device)
    t0[0] = 1.0
    for label, nwin, salt in (("window", s.recur_window, 12),
                              ("call", s.cma_call, 13)):
        n = nwin + CMA_TAPS - 1
        gen = ctx.gen(salt)
        phase = corpus.rtl_fm_iq(n + 2, ctx.device, gen)[2]
        xs = [corpus.cma_channel(phase, n, gen) for _ in range(3)]
        del phase

        def run(k, xs=xs):
            return ops.cma_equalize(xs[k % len(xs)], CMA_TAPS, 1.0, CMA_MU)

        def check(run=run, xs=xs, nwin=nwin):
            y, taps = run(0)
            k = min(s.recur_window, nwin)
            head = xs[0][: k + CMA_TAPS - 1]
            py, ptaps = kernels.cma_scan_plain(head, t0, 1.0, CMA_MU)
            y64 = corpus.cma_sequential(head.cpu().numpy(), CMA_TAPS, 1.0, CMA_MU)
            want = torch.from_numpy(y64).to(ctx.device)
            out = {f"plain version, the first {k} windows": (
                abs_err(torch.view_as_real(y[:k]), torch.view_as_real(py)), 0.0),
                f"float64 model, the first {k} windows, |error| / max|y|": (
                    float((y[:k] - want).abs().max() / want.abs().max()),
                    corpus.CMA_TOL)}
            if k == nwin:
                out["plain version, the final taps"] = (
                    abs_err(torch.view_as_real(taps), torch.view_as_real(ptaps)), 0.0)
            return out

        yield Row(f"cma/{CMA_TAPS}taps_{label}", n, {"": run}, check, kernel="cma",
                  work=kernels.cma_work(n, CMA_TAPS), rotation=len(xs),
                  fields={"ntaps": CMA_TAPS, "windows": nwin})
        del xs


def iir_rows(ctx: Ctx):
    """Kernel G (``ops.iir_filter``) at orders 2 and 8 on noise, over the
    held window and at the main path's stream, each call bit-equal to the
    plain version and within ``corpus.IIR_TOL`` of the float64 model."""
    from .. import ops
    from ..ops import kernels

    s = ctx.sizes
    for label, n, salt in (("window", s.recur_window, 14), ("call", s.iir_call, 15)):
        gen = ctx.gen(salt)
        xs = [torch.randn(n, generator=gen, device=ctx.device) for _ in range(4)]
        for taps in corpus.IIR_TAPS.values():
            order = len(taps) - 1

            def run(k, xs=xs, taps=taps):
                return ops.iir_filter(xs[k % len(xs)], taps)

            def check(run=run, xs=xs, taps=taps, order=order):
                y = run(0)
                plain = kernels.iir_scan_plain(
                    xs[0], taps, torch.zeros(order, device=ctx.device))
                want = corpus.iir_f64(xs[0], taps)
                return {"plain version": (abs_err(y, plain), 0.0),
                        "float64 model, |error| / max|y|": (
                            float((y.double() - want).abs().max() / want.abs().max()),
                            corpus.IIR_TOL)}

            yield Row(f"iir/order{order}_{label}", n, {"": run}, check, kernel="iir",
                      work=kernels.iir_work(n, order), rotation=len(xs),
                      fields={"order": order})
        del xs


BENCHES = {
    "fm_chain": fm_chain_rows,
    "native": native_rows,
    "bell202": bell202_rows,
    "fir": fir_rows,
    "fft_filter": fft_filter_rows,
    "quad_demod": quad_demod_rows,
    "channelizer": channelizer_rows,
    "decode_bank": decode_bank_rows,
    "band_clock": band_clock_rows,
    "ax25_clock": ax25_clock_rows,
    "scan_stream": lambda ctx: stream_rows(ctx, resident=False),
    "scan_stream_device": lambda ctx: stream_rows(ctx, resident=True),
    "recurrences": lambda ctx: itertools.chain(cma_rows(ctx), iir_rows(ctx)),
}


# ------------------------------------------------------------ measuring

def trace_fields(fn, calls: int = 3) -> dict:
    """One ``torch.profiler`` window of ``calls`` calls: the device's busy
    share of the window and device ms a call by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils import stats

    timing.sync()
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            timing.sync()
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        busy, span, events = stats.device_busy_share(path)
    by_name = {e.key: e.device_time_total / calls / 1e3
               for e in prof.key_averages() if e.device_time_total > 0}
    return {"busy_share": busy / span if span else None, "device_events": events,
            "device_ms_by_kernel": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8])}


def measure(row: Row, ctx: Ctx) -> dict:
    """The row's line: its checks, then (on a card) its times, launches,
    device time, bound and rate."""
    from ..ops import kernels
    from ..utils import stats

    checks = {k: (float(e), float(t)) for k, (e, t) in row.check().items()}
    line = {"bench": row.bench, "n": row.n, **row.fields,
            "platform": "gpu" if ctx.card else "cpu",
            **(ctx.card.fields() if ctx.card else {"card": None})}
    timed = {row.rate: None, "ms": None, "ms_q1": None, "ms_q3": None,
             "samples": None, "calls": None, "device_ms": None, "host_us": None,
             "launches": None, "bound_ms": None, "bound_by": None,
             "gbps": None, "roofline_pct": None}
    if row.work is not None:
        timed["work_bytes"], timed["work_flops"] = row.work
    if len(row.runs) > 1:
        for v in row.runs:
            timed[f"{v}_msps"] = timed[f"{v}_ms"] = None
    if ctx.card is not None:
        for i, (v, fn) in enumerate(row.runs.items()):
            ks = itertools.count()
            call = (lambda fn=fn, ks=ks: fn(next(ks) % row.rotation))
            if row.host:
                st = timing.host_stats(call, reps=REPS)
            else:
                st = timing.event_stats(call, reps=REPS, calls=CALLS)
            ms, msps = st["median"], row.n / st["median"] / 1e3
            if i == 0:
                timed.update({row.rate: msps}, ms=ms, ms_q1=st["q1"],
                             ms_q3=st["q3"], samples=st["n"],
                             calls=1 if row.host else CALLS)
                if "nch" in row.fields:
                    timed["per_channel_msps"] = msps / row.fields["nch"]
            if len(row.runs) > 1:
                timed[f"{v}_ms"], timed[f"{v}_msps"] = ms, msps
        timed["sm_clock_mhz"] = timing.sm_clock_mhz()
        first = next(iter(row.runs))
        if row.kernel is not None:
            fn0 = row.runs[first]
            for name in kernels.LAUNCHES:
                kernels.LAUNCHES[name] = 0
            fn0(0)
            timing.sync()
            timed["launches"] = kernels.LAUNCHES[row.kernel]
            source = row.record or fn0
            calls = [recorded(lambda k=k: source(k), row.kernel)
                     for k in range(row.rotation)]

            def replay(k):
                for f, a, kw in calls[k % len(calls)]:
                    f(*a, **kw)

            timed["device_ms"] = timing.graph_ms(replay, reps=REPS, calls=CALLS)
            if not row.host:
                timed["host_us"] = timing.host_us(lambda: fn0(0), calls=50)
            timed["bound_ms"], timed["bound_by"] = timing.bound(row.work,
                                                                ctx.card.name)
            del calls
        if row.work is not None:
            timed["gbps"] = row.work[0] / timed["ms"] / 1e6
            peaks = stats.card_peaks(ctx.card.name)
            timed["roofline_pct"] = (None if peaks is None
                                     else 100 * timed["gbps"] / peaks[0])
        if ctx.trace:
            timed["trace"] = trace_fields(lambda: next(iter(row.runs.values()))(0))
    line.update(timed)
    if row.derive is not None:
        line.update(row.derive(line))
    line["checks"] = {k: {"err": e, "tol": t} for k, (e, t) in checks.items()}
    line["correct"] = all(e <= t for e, t in checks.values())
    return line


def context(args) -> Ctx | None:
    """The run's context from the parsed arguments; None (after saying why
    on stderr) when a card is asked for and there is none."""
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(f"{args.prog}: no CUDA card (torch.cuda.is_available() is "
                  "false); the rows run on an NVIDIA GPU, or with --device cpu "
                  "on the plain versions", file=sys.stderr)
            return None
        card = timing.card()
        from ..ops import cuda_lib

        cuda_lib.load()
    return Ctx(device, SMALL if args.small else Sizes(), args.seed, card,
               trace=args.trace)


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain versions, no times")
    p.add_argument("--small", action="store_true",
                   help="every row at 2^16 samples or fewer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", action="store_true",
                   help="one torch.profiler window a row, outside the timings")
    p.set_defaults(prog=prog)
    return p


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = parser("bench_kernels", __doc__)
    p.add_argument("--only", default="",
                   help=f"groups, comma-separated: {','.join(BENCHES)}")
    args = p.parse_args(argv)
    names = [n for n in args.only.split(",") if n] or list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        p.error(f"unknown groups {unknown}; choose from {list(BENCHES)}")
    ctx = context(args)
    if ctx is None:
        return 1
    ok = True
    t0 = time.perf_counter()
    for name in names:
        for row in BENCHES[name](ctx):
            line = measure(row, ctx)
            ok &= line["correct"]
            emit(line)
    print(f"bench_kernels: {len(names)} groups in "
          f"{time.perf_counter() - t0:.1f} s; all correct: {ok}",
          file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
