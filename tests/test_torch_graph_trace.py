"""The port's Graph tracing and costs: ``run(profile_dir=)`` and
``run_stream(profile_dir=)`` write a ``torch.profiler`` trace with the
``rr::`` regions (the JAX package's tests at tests/test_graph.py:402-433,
mirrored), ``generate_stats()`` has the cost columns, ``costs()`` of a
``FirFilter`` node is kernel A's count of its calls, a replayed batch
counts what the per-chunk run counts, the kernels' work counts give the
bounds that ``chip_smoke.py`` prints (pinned at two shapes per kernel),
and ``utils.stats`` (the NVIDIA table, the bound, the busy share of a
trace, the rate meter).  CPU only; each check is exact or states its
tolerance.
"""

import glob
import json

import numpy as np
import pytest
# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process, ~2 s once: imported with this module, so that
# each test's time is its own.
import torch._dynamo  # noqa: F401

import rustradio_tpu_torch.graph as graph_mod
from rustradio_tpu import blocks as jblocks
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu_torch import blocks
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.ops import kernels
from rustradio_tpu_torch.utils import stats


def _trace_names(d):
    paths = glob.glob(str(d) + "/*.json")
    assert len(paths) == 1
    with open(paths[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def _chain(mod, graph_cls, x, extra=()):
    g = graph_cls()
    g.chain(mod.VectorSource(x), mod.AddConst(1.0), mod.MultiplyConst(2.0),
            *extra, mod.NullSink())
    return g


def test_torch_profile_dir_writes_trace_and_costs(tmp_path):
    # tests/test_graph.py::test_profile_dir_writes_trace_and_costs
    x = np.random.RandomState(0).randn(1 << 14).astype(np.float32)
    g = _chain(blocks, Graph, x)
    g.run(device="cpu", profile_dir=str(tmp_path / "trace"))
    names = _trace_names(tmp_path / "trace")
    assert {"rr::VectorSource", "rr::segment:AddConst+MultiplyConst",
            "rr::NullSink"} <= names
    assert g.trace_path.startswith(str(tmp_path / "trace"))
    assert g.costs(), "the port's cost count should be recorded"
    st = g.generate_stats()
    assert "GFLOP" in st and "roof%" in st


def test_torch_generate_stats_has_the_jax_columns():
    # the JAX package's table of the same graph has the same columns
    x = np.random.RandomState(0).randn(1 << 12).astype(np.float32)
    g = _chain(blocks, Graph, x)
    g.run(device="cpu")
    jg = _chain(jblocks, JGraph, x)
    jg.run()
    st, jst = g.generate_stats().splitlines(), jg.generate_stats().splitlines()
    assert st[0] == jst[0]
    assert [r.split()[0] for r in st] == [r.split()[0] for r in jst]


def test_torch_run_stream_profile_dir(tmp_path, monkeypatch):
    # tests/test_graph.py::test_run_stream_profile_dir, and a batched run
    x = np.random.RandomState(1).randn(1 << 14).astype(np.float32)
    g = _chain(blocks, Graph, x)
    g.run_stream(chunk_size=1 << 12, device="cpu", profile_dir=str(tmp_path / "a"))
    assert "rr::segment:AddConst+MultiplyConst" in _trace_names(tmp_path / "a")
    # the CUDA-graph path, its capture stood in for: one scan region a batch
    monkeypatch.setattr(graph_mod, "_can_capture", lambda device: True)
    monkeypatch.setattr(graph_mod, "_warm_up", lambda device, fn: (fn(), _Rec()))
    monkeypatch.setattr(graph_mod, "_capture", lambda device, fn: _Stand(fn))
    g = _chain(blocks, Graph, x)
    g.run_stream(chunk_size=1 << 11, device="cpu", scan_chunks=4,
                 profile_dir=str(tmp_path / "b"))
    names = _trace_names(tmp_path / "b")
    assert "rr::scan:AddConst+MultiplyConst" in names
    assert "rr::segment:AddConst+MultiplyConst" in names  # the first chunk


class _Rec:
    counts: dict = {}


class _Stand:
    """A capture's stand-in: each replay runs the recorded function."""

    def __init__(self, fn):
        self.fn, self.record = fn, _Rec()

    def replay(self):
        return self.fn()


@pytest.mark.parametrize("deci", [1, 3])
def test_torch_fir_filter_costs_are_kernel_a_count(deci):
    # offline: one kernel A call over the (left-padded) input; streamed:
    # one a chunk over the carried tail and the chunk.  Bytes: 4 per
    # sample the kernel reads and per output it writes (the taps left
    # out); flops: 2 * taps per output.
    rng = np.random.RandomState(2)
    x = rng.randn(5000).astype(np.float32)
    taps = rng.randn(31).astype(np.float32)

    def want(ns):
        b = f = 0
        for n in ns:
            n += (-(len(taps) - 1)) % deci  # fir_filter's grid padding
            m = -(-n // deci)
            b += 4 * (n + m)
            f += 2 * len(taps) * m
        return {"flops": float(f), "bytes": float(b)}

    g = Graph()
    g.chain(blocks.VectorSource(x), blocks.FirFilter(taps, deci=deci),
            blocks.NullSink())
    g.run(device="cpu")
    assert g.costs()[1] == want([5000])
    g = Graph()
    g.chain(blocks.VectorSource(x), blocks.FirFilter(taps, deci=deci),
            blocks.NullSink())
    g.run_stream(chunk_size=1024, device="cpu")
    ns, tail = [], 0
    for c in (1024, 1024, 1024, 1024, 904):
        n = tail + c
        ns.append(n)
        tail = n - ((n - len(taps)) // deci + 1) * deci
    assert g.costs()[1] == want(ns)
    # the same numbers as kernels.fir_work, the count chip_smoke's bound reads
    w = want([5000])
    assert kernels.fir_work(5000, 31, deci) == (w["bytes"], w["flops"])


def test_torch_replayed_batches_cost_what_chunks_cost(monkeypatch):
    # the FM chain with a MultiplyConst: per chunk and batched (the capture
    # stood in for) count the same kernel B work and the same bytes
    rng = np.random.RandomState(3)
    data = (rng.randn(4096 * 9) + 1j * rng.randn(4096 * 9)).astype(np.complex64)
    taps = (rng.randn(49) / 7).astype(np.float32)

    def run(scan):
        g = Graph()
        g.chain(blocks.VectorSource(data), blocks.FirFilter(taps, deci=4),
                blocks.QuadratureDemod(1.0), blocks.MultiplyConst(0.5),
                blocks.NullSink())
        g.run_stream(chunk_size=4096, device="cpu", scan_chunks=scan)
        return g.costs()

    want = run(None)
    monkeypatch.setattr(graph_mod, "_can_capture", lambda device: True)
    monkeypatch.setattr(graph_mod, "_warm_up", lambda device, fn: (fn(), _Rec()))
    monkeypatch.setattr(graph_mod, "_capture", lambda device, fn: _Stand(fn))
    assert run(4) == want
    # kernel B's work on the first member: 9 chunks of 1024 outputs
    flops = sum(2 * 2 * c * 49 for c in [1024 - 12] + [1024] * 8)
    assert want[1]["flops"] == flops


def test_torch_kernel_records_count_work():
    x = np.zeros(4096, np.float32)
    import torch

    w0 = dict(kernels.WORK)
    with kernels.recording() as rec:
        kernels.fir_decimate(torch.from_numpy(x), np.ones(7, np.float32), 2)
    assert kernels.WORK == w0 and rec.work == {
        "bytes": 4.0 * (4096 + 2048), "flops": 2.0 * 2048 * 7}
    kernels.replayed(rec)
    assert kernels.WORK["bytes"] == w0["bytes"] + rec.work["bytes"]


# the bounds chip_smoke.py printed before the counts moved into the
# package, at two shapes per kernel (H100 SXM: 3.35e12 B/s, 67e12 op/s)
_OLD = {
    "A 49/4 2^22": (4 * (2**22 + 2**20), 2 * 2**20 * 49),
    "A 1205/1 2^22": (4 * (2**22 + 2**22), 2 * 2**22 * 1205),
    "B packed w3 2^24": (2 * 2**24 * 2 + 4 * 2**22, 2 * 2 * 2**22 * 49),
    "B flat i8 deci 1": (2 * 2**24 * 1 + 4 * 2**24, 2 * 2 * 2**24 * 49),
    "C 2^24": (8 * 2**24 + 4 * (2**24 - 1), 0.0),
    "C 2^20": (8 * 2**20 + 4 * (2**20 - 1), 0.0),
    "D 64x7133 real 300000": (12 * 64 * 7133, 300000 * (30 + 1)),
    "D 8x100 real 50": (12 * 800, 50 * (30 + 5)),
    "E 64x4096 36.75": (9 * 64 * 4096, 64 * 4096 + 2 * 64 * 4096 / 36.75
                        + 7000 * (15 + 1)),
    "E 2x1000 26.7": (9 * 2000, 2000 + 2 * 2000 / 26.7 + 30 * (15 + 3)),
}
_NEW = {
    "A 49/4 2^22": kernels.fir_work(2**22, 49, 4),
    "A 1205/1 2^22": kernels.fir_work(2**22, 1205, 1),
    "B packed w3 2^24": kernels.fm_chain_work(2**22, 49, 4, 2),
    "B flat i8 deci 1": kernels.fm_chain_work(2**24, 49, 1, 1),
    "C 2^24": kernels.quad_work(2**24),
    "C 2^20": kernels.quad_work(2**20),
    "D 64x7133 real 300000": kernels.events_work(64 * 7133, 300000, 1),
    "D 8x100 real 50": kernels.events_work(800, 50, 5),
    "E 64x4096 36.75": kernels.scan_work(64 * 4096, 36.75, 7000, 1),
    "E 2x1000 26.7": kernels.scan_work(2000, 26.7, 30, 3),
}


@pytest.mark.parametrize("row", sorted(_OLD))
def test_torch_kernel_work_gives_the_old_bounds(row):
    peaks = stats.card_peaks("NVIDIA H100 80GB HBM3")
    old = _OLD[row]
    tb, tf = old[0] / 3.35e12 * 1e3, old[1] / 67e12 * 1e3
    want = (tb, "bytes") if tb >= tf else (tf, "operations")
    got = stats.bound_ms(*_NEW[row], *peaks)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


def test_torch_stats_cards_and_meter(tmp_path):
    assert stats.card_peaks("NVIDIA H100 80GB HBM3") == (3350.0, 67e12)
    assert stats.card_peaks("NVIDIA H100 PCIe") == (2000.0, 51.2e12)
    assert stats.card_peaks("some other card") is None
    assert stats.device_hbm_gbps("cpu") is None
    assert "no device memory rate" in stats.roofline_report(1e9, 1.0, "cpu")
    m = stats.RateMeter()
    m.add(1000)
    assert m.samples == 1000 and "1000 samples" in m.report()
    # the busy share of a trace: the union of the device's intervals
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 60, "dur": 10},
    ]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(trace))
    busy, span, n = stats.device_busy_share(str(p))
    assert (busy, span, n) == (pytest.approx(40e-6), pytest.approx(100e-6), 3)
