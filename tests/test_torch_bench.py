"""The port's benchmark programs (``rustradio_tpu_torch/tools/bench.py``,
``bench_kernels.py``, ``check_fm_accuracy.py``) on the CPU: every row
rehearsed with ``--device cpu --small`` (its line, its keys, null device
fields), each row's function against its JAX counterpart on the same
seeded numpy input (the Pallas rows in interpret mode, as
tests/test_pallas_interpret.py runs them), the float64 model against the
JAX script's, the bounds against ``kernels.*_work`` with a stand-in card
and timer, and the refusals: no card, and a check that fails.
"""

import importlib.util
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import rustradio_tpu.ops.pallas_kernels as pk
from rustradio_tpu import blocks as jblocks
from rustradio_tpu import native as jnative
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.models import ax25 as jax25
from rustradio_tpu.ops.fft_filter import fft_filter_decimate as jfft_decimate
from rustradio_tpu.parallel import channelizer as jch
from rustradio_tpu_torch import blocks, native, ops
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.models import ax25
from rustradio_tpu_torch.ops import kernels
from rustradio_tpu_torch.ops.fft_filter import fft_filter_decimate
from rustradio_tpu_torch.parallel import channelizer
from rustradio_tpu_torch.tools import (bench, bench_kernels, check_fm_accuracy,
                                       corpus, timing)
from rustradio_tpu_torch.utils import stats

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"
SMALL = ["--device", "cpu", "--small"]
# every line's fields that hold a device number, null on the CPU
DEVICE_FIELDS = ("msps", "ms", "ms_q1", "ms_q3", "samples", "device_ms",
                 "host_us", "launches", "bound_ms", "gbps", "roofline_pct")
PROGRAMS = {"bench_kernels": bench_kernels, "bench": bench,
            "check_fm_accuracy": check_fm_accuracy}


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _lines(out: str) -> list[dict]:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _wire_noise(rng, n):
    """corpus.wire_noise's grid from numpy: round(clip(38 N(0, 1))) / 128."""
    return (np.round(np.clip(rng.randn(n) * 38, -127, 128)) / 128).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- (a) every row rehearsed on the CPU

@pytest.mark.parametrize("group", list(bench_kernels.BENCHES))
def test_torch_bench_kernels_rows_rehearse_on_the_cpu(group, capsys):
    assert bench_kernels.main(SMALL + ["--only", group]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines
    for line in lines:
        assert line["platform"] == "cpu" and line["card"] is None
        assert line["correct"] is True and line["checks"]
        assert all(line[k] is None for k in DEVICE_FIELDS if k in line), line
        assert "msps" in line or line["bench"] == "native_hdlc_deframe" and "mbps" in line
        assert set(line) >= {"bench", "bound_by", "calls", "checks"}
        if "n" in line:
            assert line["n"] <= 1 << 16
    names = {line["bench"] for line in lines}
    want = {"fm_chain": {"fm_chain/w3", "fm_chain/i8", "fm_chain/highest",
                         "fm_chain/split3", "fm_chain/w2", "fm_ingest_pack"},
            "fir": {f"fir_banded/deci{d}_taps{t}" for d, t in bench_kernels.FIR_SHAPES},
            "native": {"native_symbol_sync", "native_hdlc_deframe"},
            "decode_bank": {"decode_bank/4ch", "decode_bank_events/4ch"},
            "scan_stream": {"scan_stream"}, "scan_stream_device": {"scan_stream_device"},
            "bell202": {"bell202_frontend"}, "fft_filter": {"fft_filter_decimate"},
            "quad_demod": {"quad_demod"}, "channelizer": {"channelizer/256ch"}}
    assert names == want[group]


def test_torch_bench_headline_rehearses_on_the_cpu(capsys):
    assert bench.main(SMALL) == 0
    (line,) = _lines(capsys.readouterr().out)
    assert line["metric"] == "fm_demod_chain_throughput" and line["platform"] == "cpu"
    for key in ("value", "vs_baseline", "gbps", "roofline_pct", "graph_fm_chain_msps",
                "channelizer_256ch_msps", "fm_chain_i8_msps", "decode_bank_events_msps"):
        assert key in line and line[key] is None
    assert line["unit"] == "Msamples/s" and line["correct"] is True
    assert set(line["rows"]) == {"fm_chain/w3", "fm_chain/i8", "graph_fm_chain",
                                 "channelizer/256ch", "decode_bank_events/4ch"}


def test_torch_check_fm_accuracy_rehearses_on_the_cpu(capsys):
    assert check_fm_accuracy.main(SMALL) == 0
    lines = _lines(capsys.readouterr().out)
    assert [x["precision"] for x in lines] == ["highest", "w3", "i8", "w2", "split3"]
    for x in lines:
        assert x["platform"] == "cpu" and x["ms"] is None and x["correct"] is True
        assert x["within_1e3_budget"] is True and x["max_err_rad"] <= x["budget_rad"]


# ---- (b) each row's function against its JAX counterpart

@pytest.mark.parametrize("precision", list(bench_kernels.BUDGET))
def test_torch_bench_fm_chain_row_matches_jax(interpret_kernels, precision):
    # the row's call: packed planes of wire-grid noise, an offset folded in;
    # JAX's double-buffered kernel on its own packing, in interpret mode
    rng = np.random.RandomState(0)
    n, tile_rows, offset = 3 * 128 * 16 * 4 + 57, 16, 1e-3 / 16
    a, b = _wire_noise(rng, n), _wire_noise(rng, n)
    lp = corpus.fm_taps()
    pa, pb = (kernels.fm_plane_pack(_t(v), lp, 4, tile_rows, precision) for v in (a, b))
    got = kernels.fm_chain(pa, pb, lp, 4, 1.0, tile_rows=tile_rows, offset=offset,
                           precision=precision, n=n).numpy()
    ja, jb = (pk.fm_plane_pack(v, lp, 4, tile_rows, precision) for v in (a, b))
    want = np.asarray(pk.pallas_fm_chain(ja, jb, lp, 4, 1.0, tile_rows=tile_rows,
                                         offset=offset, precision=precision, n=n))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=bench_kernels.BUDGET[precision], rtol=0)


def test_torch_bench_ingest_pack_row_matches_jax():
    rng = np.random.RandomState(1)
    n = 1 << 14
    a, lp = _wire_noise(rng, n), corpus.fm_taps()
    got = kernels.fm_plane_pack(_t(a), lp, 4, None, "w3")
    want = np.asarray(pk.fm_plane_pack(a, lp, 4, None, "w3")).reshape(-1)
    assert got.shape == want.shape
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("deci,ntaps", bench_kernels.FIR_SHAPES)
def test_torch_bench_fir_row_matches_jax(interpret_kernels, deci, ntaps):
    rng = np.random.RandomState(2)
    x = rng.randn(2 * 128 * 128 + 77).astype(np.float32)
    taps = bench_kernels.fir_taps(deci, ntaps)
    got = kernels.fir_decimate(_t(x), taps, deci).numpy()
    want = np.asarray(pk.pallas_fir_decimate(x, taps, deci, tile_rows=128))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_torch_bench_fft_filter_row_matches_jax():
    from rustradio_tpu import taps as jtaps

    rng = np.random.RandomState(3)
    n = 3 * 8192 + 11
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    lp = np.asarray(jtaps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0, "hamming"))
    got = fft_filter_decimate(_t(x), lp, 4, fft_size=8192).numpy()
    want = np.asarray(jfft_decimate(x, lp, 4, fft_size=8192))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_torch_bench_quad_demod_row_matches_jax(interpret_kernels):
    rng = np.random.RandomState(4)
    n = 2 * 128 * 128 + 100
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = ops.quad_demod_fast(_t(x), 1.0)
    want = np.asarray(pk.pallas_quad_demod(x, 1.0, tile_rows=128))
    assert bench_kernels.wrapped(got, want) <= bench_kernels.QUAD_TOL


def test_torch_bench_channelizer_row_matches_jax():
    rng = np.random.RandomState(5)
    m = bench_kernels.PFB_CH
    x = (rng.randn(m * 64) + 1j * rng.randn(m * 64)).astype(np.complex64)
    taps = channelizer.channelizer_taps(m)
    got = channelizer.pfb_channelize(_t(x), taps, m).numpy()
    want = np.asarray(jax.jit(lambda v: jch.pfb_channelize(v, jch.channelizer_taps(m), m))(x))
    assert got.shape == want.shape == (64, m)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    # and the row's float64 model of it
    np.testing.assert_allclose(got, bench_kernels.pfb_f64(x, taps, m, 64),
                               atol=bench_kernels.FIR_TOL * np.abs(want).max(), rtol=0)


def test_torch_bench_bell202_row_matches_jax():
    # the row's three kernel-A stages against JAX's filters (the FIR
    # budget), and the whole front-end where the analytic signal is not
    # near zero (a noise input's discriminator flips at +-pi elsewhere)
    from rustradio_tpu import ops as jops
    from rustradio_tpu import taps as jtaps

    fs = bench_kernels.FS_BELL
    rng = np.random.RandomState(6)
    audio = rng.randn(1 << 14).astype(np.float32)
    calls = bench_kernels.recorded(lambda: ax25.bell202_demod(_t(audio), fs),
                                   "fir_decimate")
    assert [len(c[1][1]) for c in calls] == [len(t) for t in bench_kernels.bell202_taps(fs)]
    band = np.asarray(jops.filter_float(audio, jtaps.band_pass(fs, 400.0, 2700.0, 65)))
    got_band = calls[0][0](*calls[0][1]).numpy()
    np.testing.assert_allclose(got_band, band, atol=2e-5 * np.abs(band).max(), rtol=0)
    got = ax25.bell202_demod(_t(audio), fs).numpy()
    want = np.asarray(jax25.bell202_demod(audio, fs))
    assert got.shape == want.shape
    assert np.median(np.abs(got - want)) < 1e-6


@pytest.mark.parametrize("scan", [None, 4])
def test_torch_bench_stream_row_matches_jax(scan):
    # the streams' chain over real noise in chunks, per chunk and batched,
    # to a sink on each side
    rng = np.random.RandomState(8)
    chunk, n_chunks = 2048, 6
    data = rng.randn(chunk * n_chunks).astype(np.float32)
    taps = corpus.fm_taps()

    def run(mod, graph_cls, **kw):
        g, sink = graph_cls(), mod.VectorSink()
        g.chain(mod.VectorSource(data), mod.FirFilter(taps), mod.QuadratureDemod(1.0),
                mod.MultiplyConst(bench_kernels.STREAM_GAIN), sink)
        g.run_stream(chunk_size=chunk, scan_chunks=scan, **kw)
        return np.asarray(sink.data())

    got = run(blocks, Graph, device="cpu")
    want = run(jblocks, JGraph)
    # a real stream's discriminator gives 0 or +-pi/2, the sign of an exact
    # zero imaginary part deciding which of the last two: held wrapped
    assert got.shape == want.shape
    assert bench_kernels.wrapped(_t(got), want, bench_kernels.STREAM_GAIN) <= 1e-6


def test_torch_bench_native_rows_match_jax():
    rng = np.random.RandomState(9)
    x = (np.repeat(rng.randint(0, 2, 600) * 2.0 - 1.0, 37)
         + rng.randn(600 * 37) * 0.1).astype(np.float32)
    taps = np.asarray([0.5, 0.5])
    want = jnative.symbol_sync_f32(x, 36.75, 0.5, taps)[0]
    assert np.array_equal(native.symbol_sync_f32(x, 36.75, 0.5, taps), want)
    frames = [np.asarray(ops.hdlc_frame(ops.fcs_add(rng.randint(0, 256, 64).astype(np.uint8))))
              for _ in range(4)]
    stream = np.concatenate(frames * 2).astype(np.uint8)
    got = [bytes(p) for p, _ in native.HdlcDeframer(1, 1500, False, False).feed(stream)]
    want = [bytes(p) for p, _ in jnative.HdlcDeframer(1, 1500, False, False).feed(stream)]
    assert got == want and len(got) == 8


def test_torch_bench_graph_row_matches_jax(interpret_kernels):
    # the headline's Graph device loop at a small ring: the folds of both
    # packages over the same planes
    rng = np.random.RandomState(10)
    tile_rows, chunk, n_chunks = 16, 4 * 128 * 16, 6
    ring = [_wire_noise(rng, 4 * chunk) for _ in range(2)]
    lp = corpus.fm_taps()

    def fold(mod, graph_cls, planes, **kw):
        g = graph_cls()
        src = g.add(mod.PackedIqRingSource(*planes, lp, 4, precision="w3",
                                           tile_rows=tile_rows))
        fir = g.add(mod.FirFilter(lp, deci=4, precision="w3"), src)
        qd = g.add(mod.QuadratureDemod(1.0), fir)
        g.add(mod.DeviceFoldSink(), qd)
        return float(next(iter(g.compile_device_loop(chunk, n_chunks, **kw)(0).values())))

    got = fold(blocks, Graph, [_t(p) for p in ring], device="cpu")
    want = fold(jblocks, JGraph, ring)
    assert abs(got - want) <= 1e-4 * abs(want) + 1e-3


def test_torch_bench_accuracy_rows_match_jax():
    # check_fm_accuracy's flat-plane call: JAX's pallas_fm_chain on the CPU
    rng = np.random.RandomState(7)
    n = 1 << 13
    a = (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0
    b = (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0
    lp = corpus.fm_taps()
    for precision in check_fm_accuracy.PRECISIONS:
        got = kernels.fm_chain(_t(a), _t(b), lp, 4, 1.0, precision=precision).numpy()
        want = np.asarray(pk.pallas_fm_chain(a, b, lp, 4, 1.0, precision=precision))
        np.testing.assert_allclose(got, want, atol=bench_kernels.BUDGET[precision], rtol=0)


# ---- (c) the float64 model is the JAX script's

def test_torch_bench_float64_model_is_the_jax_scripts():
    spec = importlib.util.spec_from_file_location(
        "check_fm_accuracy_jax", ROOT / "benches" / "check_fm_accuracy.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rng = np.random.RandomState(7)
    a, b = (((rng.randint(0, 256, 5001) - 127.0) / 128.0).astype(np.float32)
            for _ in range(2))
    lp = corpus.fm_taps()
    for deci in (1, 4):
        assert np.array_equal(corpus.fm_chain_f64(a, b, lp, 0.7, deci),
                              script.fm_chain_f64(a, b, lp, deci, 0.7))
        assert np.array_equal(corpus.fir_deci_f64(a, lp, deci),
                              script._fir_deci_f64(a, lp, deci))


# ---- (d) the bounds are kernels.*_work at the rows' shapes

def bench_stand_ins(monkeypatch):
    """The card's timers stood in for: each runs its function (a replay
    over two rotations) and returns fixed times; the card is an H100."""
    def stats_of(fn, *a, **kw):
        fn()
        return timing.spread([1.0, 2.0, 4.0])

    def graph_ms(fn, reps=5, calls=10):
        fn(0), fn(1)
        return 0.5

    monkeypatch.setattr(timing, "event_stats", stats_of)
    monkeypatch.setattr(timing, "host_stats", stats_of)
    monkeypatch.setattr(timing, "graph_ms", graph_ms)
    monkeypatch.setattr(timing, "host_us", lambda fn, calls=200: (fn(), 3.0)[1])
    monkeypatch.setattr(timing, "sm_clock_mhz", lambda: 1980.0)
    return timing.Card(H100, 700.0)


def _want_work(line):
    """The row's work from its printed shapes (None: no kernel carries it)."""
    b, n = line["bench"], line.get("n")
    if b.startswith("fm_chain/"):
        return kernels.fm_chain_work(-(-n // 4), 49, 4,
                                     {"highest": 4, "split3": 4, "w3": 2, "w2": 2,
                                      "i8": 1}[line["precision"]])
    if b.startswith("fir_banded/"):
        return kernels.fir_work(n, line["ntaps"], line["deci"])
    if b == "quad_demod":
        return kernels.quad_work(n)
    if b == "bell202_frontend":
        parts = [kernels.fir_work(n, len(t), 1)
                 for t in bench_kernels.bell202_taps(bench_kernels.FS_BELL)]
        return tuple(map(sum, zip(*parts)))
    if b.startswith("scan_stream"):
        total = line["chunk"] * line["n_chunks"]
        return kernels.fm_chain_work(total - 48, 49, 1, 4)
    if b.startswith("decode_bank"):  # the row's first bank's crossings
        ch, per = line["nch"], bench_kernels.SMALL.bank_n
        bank = corpus.decode_bank("cpu", torch.Generator().manual_seed(7), ch, per)
        sign = bank > 0
        cross = (sign[:, 1:] != sign[:, :-1]).sum(1)
        if "events" in b:
            return kernels.events_work(ch * line["slots"],
                                       int(cross.clamp(max=line["slots"]).sum()), 1)
        return kernels.scan_work(ch * per, 36.75, int(cross.sum()), 1)
    return None


@pytest.mark.parametrize("group", list(bench_kernels.BENCHES))
def test_torch_bench_bounds_are_the_work_counts(monkeypatch, group):
    card = bench_stand_ins(monkeypatch)
    ctx = bench_kernels.Ctx(torch.device("cpu"), bench_kernels.SMALL, card=card)
    peaks = stats.card_peaks(H100)
    for row in bench_kernels.BENCHES[group](ctx):
        line = bench_kernels.measure(row, ctx)
        assert line["correct"] and line["card"] == H100 and line["ms"] == 2.0
        assert line["ms_q1"] == 1.5 and line["ms_q3"] == 3.0 and line["samples"] == 3
        assert line[row.rate] == row.n / 2.0 / 1e3 and line["n"] == row.n
        want = _want_work(line)
        if want is None:
            assert line["bound_ms"] is None and line["device_ms"] is None
            continue
        assert (line["work_bytes"], line["work_flops"]) == tuple(map(float, want))
        assert (line["bound_ms"], line["bound_by"]) == stats.bound_ms(*want, *peaks)
        assert line["gbps"] == want[0] / 2.0 / 1e6
        assert math.isclose(line["roofline_pct"], 100 * line["gbps"] / peaks[0])
        assert line["device_ms"] == 0.5 and line["launches"] == 0


def test_torch_bench_headline_bound_and_rate(monkeypatch):
    card = bench_stand_ins(monkeypatch)
    ctx = bench_kernels.Ctx(torch.device("cpu"), bench_kernels.SMALL, card=card)
    line = bench.headline(ctx)
    n, loop_n = bench_kernels.SMALL.fm_n, bench_kernels.SMALL.loop_n
    work = kernels.fm_chain_work(n // 4, 49, 4, 2)
    assert line["correct"] and line["value"] == n / 2.0 / 1e3
    assert line["vs_baseline"] == line["value"] / 85.4
    assert line["gbps"] == 5 * n / 2.0 / 1e6 == work[0] / 2.0 / 1e6
    assert (line["bound_ms"], line["bound_by"]) == stats.bound_ms(*work, *stats.card_peaks(H100))
    loop = kernels.fm_chain_work(loop_n // 4, 49, 4, 2)
    assert line["rows"]["graph_fm_chain"]["bound_ms"] == stats.bound_ms(
        *(bench_kernels.SMALL.loop_chunks * w for w in loop), *stats.card_peaks(H100))[0]
    assert line["card"] == H100 and line["power_limit_w"] == 700.0


# ---- (e) no card, no run; (f) a failed check fails the run

@pytest.mark.parametrize("program", list(PROGRAMS))
def test_torch_bench_without_a_card_exits_non_zero(monkeypatch, capsys, program):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PROGRAMS[program].main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


@pytest.mark.parametrize("group,plain", [("quad_demod", "quad_demod_fast_plain"),
                                         ("fir", "_fir_planes_plain"),
                                         ("fm_chain", "fm_chain_span_plain")])
def test_torch_bench_a_wrong_plain_version_fails_the_row(monkeypatch, capsys, group,
                                                         plain):
    real = getattr(kernels, plain)

    def off(*a, **kw):
        out = real(*a, **kw)
        return (out[0] + 1e-2, out[1]) if isinstance(out, tuple) else out + 1e-2

    monkeypatch.setattr(kernels, plain, off)
    assert bench_kernels.main(SMALL + ["--only", group]) == 1
    lines = _lines(capsys.readouterr().out)
    assert any(line["correct"] is False for line in lines)
