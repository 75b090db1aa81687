"""The port's program spans (``utils.trace.span``) and the deframer's
counters (``ops.hdlc.TOTALS``): under a running ``torch.profiler`` the
AX.25 receiver's and the FM chain's ``rr::`` spans are recorded once a
call, nested in the call's own span on the caller's thread; with no
profiler no ``record_function`` is made; the Graph's block spans open
under any profiler; a corrupted CRC is counted.  CPU only.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rustradio_tpu_torch import blocks, ops
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.models import ax25, fm
from rustradio_tpu_torch.ops import hdlc
from rustradio_tpu_torch.utils import trace
from test_decode_rate import FS, _afsk, _nrzi_line
from test_torch_ax25 import _corpus

AX25_SPANS = {"rr::ax25.rx", "rr::ax25.front_end", "rr::ax25.clock",
              "rr::ax25.compact", "rr::ax25.bits", "rr::hdlc.to_host",
              "rr::hdlc.deframe", "rr::ax25.packets"}
FM_SPANS = {"rr::fm.chain", "rr::kernels.plane_cast"}


@pytest.fixture(scope="module")
def corpus():
    return _corpus(2)  # the plain clock recovery under a profiler: ~4 s a frame


def _planes(n=1 << 12):
    rng = np.random.RandomState(3)
    # on the (u8 - 127) / 128 grid, which precision "w3" holds exactly
    return [torch.from_numpy(((rng.randint(0, 256, n) - 127) / 128.0)
                             .astype(np.float32)) for _ in range(2)]


def _fm_pass(i, q):
    return fm.fm_demod_chain_planar(i, q, deci=1, gain=2.0, precision="w3")


def _traced(fn):
    """fn() under a CPU profiler: its result and the ``rr::`` spans
    recorded, as (name, start, end, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end, e.thread)
                 for e in prof.events() if e.name.startswith("rr::")]


def _nested_once(spans, names, outer):
    """Every span of ``names`` recorded once, inside ``outer``'s interval
    on its thread."""
    assert sorted(s[0] for s in spans) == sorted(names)
    (_, t0, t1, tid), = [s for s in spans if s[0] == outer]
    for name, a, b, thread in spans:
        assert thread == tid and t0 <= a <= b <= t1, name
    # the kernel-time metric matches names on "symbol_sync": no span may
    assert not any("symbol_sync" in s[0] for s in spans)


@pytest.mark.parametrize("sync", ["events", "native"])
def test_torch_ax25_spans_nest_in_the_pass(corpus, sync):
    audio, payloads = corpus
    pkts, spans = _traced(lambda: ax25.ax25_1200_rx(audio, FS, sync=sync,
                                                    device="cpu"))
    assert [bytes(p) for p in pkts] == payloads
    want = AX25_SPANS - ({"rr::ax25.compact"} if sync == "native" else set())
    _nested_once(spans, want, "rr::ax25.rx")


def test_torch_fm_spans_nest_in_the_chain():
    i, q = _planes()
    y, spans = _traced(lambda: _fm_pass(i, q))
    torch.testing.assert_close(y, _fm_pass(i, q), rtol=0, atol=0)
    _nested_once(spans, FM_SPANS, "rr::fm.chain")


def test_torch_no_record_function_without_a_profiler(corpus, monkeypatch):
    assert trace.span("ax25.rx") is trace.span("fm.chain") is trace._OFF
    made = []

    def record_function(name):
        made.append(name)
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    audio, payloads = corpus
    got = ax25.ax25_1200_rx(audio, FS, sync="events", device="cpu")
    assert [bytes(p) for p in got] == payloads
    _fm_pass(*_planes())
    g = Graph()
    g.chain(blocks.VectorSource(np.ones(1 << 10, np.float32)),
            blocks.AddConst(1.0), blocks.NullSink())
    g.run(device="cpu")
    assert made == []


def test_torch_graph_spans_open_under_an_outside_profiler():
    g = Graph()
    g.chain(blocks.VectorSource(np.ones(1 << 12, np.float32)),
            blocks.AddConst(1.0), blocks.MultiplyConst(2.0), blocks.NullSink())
    _, spans = _traced(lambda: g.run(device="cpu"))
    assert {"rr::VectorSource", "rr::segment:AddConst+MultiplyConst",
            "rr::NullSink"} <= {s[0] for s in spans}
    assert g.trace_path is None  # no profile_dir: nothing written


def test_torch_hdlc_totals_count_a_corrupted_crc():
    parts, payloads = [], []
    for k in range(5):
        p = f"N0CALL-{k}>APRS:totals {k} {'z' * 3 * k}".encode()
        framed = ops.fcs_add(np.frombuffer(p, np.uint8))
        if k == 2:
            framed[-1] ^= 0x10  # this frame's CRC no longer matches
        else:
            payloads.append(p)
        parts.append(_afsk(_nrzi_line(ops.hdlc_frame(framed)), 1200.0, 0.5))
    before = dict(hdlc.TOTALS)
    got = ax25.ax25_1200_rx(np.concatenate(parts), FS, sync="events",
                            device="cpu")
    assert [bytes(p) for p in got] == payloads
    assert {k: hdlc.TOTALS[k] - before[k] for k in before} == \
        {"decoded": 4, "crc_error": 1, "bitfixed": 0}
