"""The port's streaming runner (``Graph.run_stream``) against its offline
run and against the JAX package's ``run_stream``: a dense float chain, a
lowered FM pair (flat and over a packed ring), tags, cancellation, the
end-of-stream drain, the HDLC tail without duplicates, checkpoint/resume
(through SymbolSync, both methods), and a checkpoint written by the JAX
package resumed by the port.  The JAX side runs on the CPU, the port on
the kernels' plain versions; inputs are seeded numpy arrays.
"""

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu import ops as jops
from rustradio_tpu import taps as jtaps
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.streams import Tag as JTag
from rustradio_tpu_torch import blocks, lowering, ops
from rustradio_tpu_torch.blocks.base import Block
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.streams import Tag
from test_models import make_afsk

FS = 24_000.0


def _sweep(n, seed):
    """A tone swept around 1.5 kHz in noise, at FS."""
    rng = np.random.RandomState(seed)
    f = 1500.0 + 500.0 * np.sin(np.arange(n) * 2e-3)
    return (np.sin(2 * np.pi * np.cumsum(f) / FS)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _dense(mod, graph_cls, x):
    """FftFilterFloat -> Hilbert -> QuadratureDemod -> FftFilterFloat ->
    AddConst, the AX.25 receiver's dense front-end."""
    g, sink = graph_cls(), mod.VectorSink()
    g.chain(mod.VectorSource(x),
            mod.FftFilterFloat(jtaps.band_pass(FS, 400.0, 2700.0, 65, "hamming")),
            mod.Hilbert(65), mod.QuadratureDemod(1.0),
            mod.FftFilterFloat(jtaps.low_pass(FS, 1100.0, 200.0, "hamming")),
            mod.AddConst(np.float32(-0.4)), sink)
    return g, sink


def test_torch_run_stream_dense_chain_matches_offline_and_jax():
    x = _sweep(10_000, 80)
    g, s = _dense(blocks, Graph, x)
    g.run(device="cpu")
    offline = s.data()
    g, s = _dense(blocks, Graph, x)
    g.run_stream(chunk_size=2500, device="cpu")
    streamed = s.data()
    jg, js = _dense(jblocks, JGraph, x)
    jg.run_stream(chunk_size=2500)
    want = np.asarray(js.data())
    assert streamed.shape == offline.shape == want.shape == (len(x) - 1,)
    # the same f32 FIRs at other alignments, then the exact discriminator
    # on a strong signal: 1e-5 (measured 3e-7); the JAX chain filters by
    # overlap-save FFT: 1e-4 (measured 5e-7)
    np.testing.assert_allclose(streamed, offline, atol=1e-5, rtol=0)
    np.testing.assert_allclose(streamed, want, atol=1e-4, rtol=0)


def _fm_pair(mod, graph_cls, data, taps):
    g, sink = graph_cls(), mod.VectorSink()
    g.chain(mod.VectorSource(data), mod.FirFilter(taps, deci=4),
            mod.QuadratureDemod(1.5), sink)
    return g, sink


def test_torch_run_stream_lowers_the_fm_pair(monkeypatch):
    rng = np.random.RandomState(81)
    taps = (rng.randn(49) / 7).astype(np.float32)
    data = (rng.randn(8000) + 1j * rng.randn(8000)).astype(np.complex64)
    calls = []
    real = lowering.fused_fm_chunk
    monkeypatch.setattr(lowering, "fused_fm_chunk",
                        lambda *a: calls.append(1) or real(*a))
    g, s = _fm_pair(blocks, Graph, data, taps)
    g.run_stream(chunk_size=1999, device="cpu")
    assert len(calls) == 5  # one kernel-B pass a chunk (4 + the last 4)
    g2, s2 = _fm_pair(blocks, Graph, data, taps)
    g2.run(device="cpu")
    jg, js = _fm_pair(jblocks, JGraph, data, taps)
    jg.run_stream(chunk_size=1999)
    assert s.data().shape == s2.data().shape == np.asarray(js.data()).shape
    # the lowered kernel's fast atan2 against JAX's exact one (unlowered
    # on the CPU): the lowering's budget, 3e-4 (test_torch_graph.py)
    np.testing.assert_allclose(s.data(), np.asarray(js.data()), atol=3e-4, rtol=0)
    # lowered chunks against the lowered offline pass: same kernel numerics
    np.testing.assert_allclose(s.data(), s2.data(), atol=1e-5, rtol=0)


def test_torch_run_stream_over_a_packed_ring_equals_the_device_loop():
    # PackedIqRingSource -> FM pair, streamed into a VectorSink, against the
    # device loop over the same ring (a fold that keeps every output)
    rng = np.random.RandomState(82)
    taps = (rng.randn(49) / 7).astype(np.float32)
    deci, tile_rows = 4, 16
    chunk = deci * 128 * tile_rows
    re, im = (np.round(np.clip(rng.randn(2, 2 * chunk) * 38, -128, 127)) / 128
              ).astype(np.float32)

    def build(sink):
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(re, im, taps, deci,
                                              tile_rows=tile_rows))
        fir = g.add(blocks.FirFilter(taps, deci=deci, precision="w3"), src)
        g.add(sink, g.add(blocks.QuadratureDemod(1.5), fir))
        return g

    s = blocks.VectorSink()
    with pytest.raises(ValueError, match="max_chunks"):
        build(s).run_stream(chunk_size=chunk, device="cpu")
    build(s).run_stream(chunk_size=chunk, max_chunks=3, device="cpu")
    keep = blocks.DeviceFoldSink(fn=lambda c, y: torch.cat([c.reshape(-1), y]))
    loop = build(keep).compile_device_loop(chunk, 3, device="cpu")
    want = next(iter(loop(0).values()))[1:].numpy()
    assert s.data().shape == want.shape
    assert np.array_equal(s.data(), want)


def test_torch_run_stream_tags_match_jax():
    x = np.arange(3000, dtype=np.float32) / 3000
    user = [(5, "user::a"), (1234, "user::b"), (2999, "user::c")]
    taps = np.ones(7, np.float32) / 7

    def build(mod, graph_cls, tag_cls):
        g, sink = graph_cls(), mod.VectorSink()
        g.chain(mod.VectorSource(x, repeat=2,
                                 tags=[tag_cls(p, k, i) for i, (p, k) in enumerate(user)]),
                mod.AddConst(1.0), mod.FirFilter(taps, deci=2), sink)
        return g, sink

    jg, js = build(jblocks, JGraph, JTag)
    jg.run_stream(chunk_size=1000)
    g, s = build(blocks, Graph, Tag)
    g.run_stream(chunk_size=1000, device="cpu")
    want = [(t.pos, t.key, t.val) for t in js.tags()]
    got = [(t.pos, t.key, t.val) for t in s.tags()]
    assert got == want
    assert {k for _, k, _ in got} >= {"VectorSource::start", "VectorSource::repeat",
                                      "VectorSource::first", "user::b"}
    np.testing.assert_allclose(s.data(), np.asarray(js.data()), atol=1e-6)


class _CancelAfter(Block):
    """Passes samples through and cancels its graph at its k-th chunk."""

    def __init__(self, token, k):
        self.token, self.k, self.seen = token, k, 0

    def apply(self, x):
        return x

    def apply_chunk(self, state, x):
        self.seen += 1
        if self.seen == self.k:
            self.token.cancel()
        return state, x


class _HoldBack(Block):
    """Delays its stream by k samples; the last k come out only at the end
    of the stream, from the carried state (``flush_with_state``)."""

    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return x[: max(x.shape[0] - self.k, 0)]

    def flush(self):
        return None

    def init_state(self):
        return torch.zeros(0)

    def apply_chunk(self, state, x):
        ext = torch.cat([state.to(x), x])
        cut = max(ext.shape[0] - self.k, 0)
        return ext[cut:].clone(), ext[:cut]

    def flush_with_state(self, state):
        return state


def test_torch_cancellation_token():
    # cancelled before the run: nothing, offline or streamed
    for stream in (False, True):
        g, s = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(np.ones(10, np.float32)), s)
        g.cancel_token().cancel()
        if stream:
            g.run_stream(chunk_size=4, device="cpu")
        else:
            g.run(device="cpu")
        assert g.cancel_token().is_cancelled() and len(s.data()) == 0
    # cancelled during the third chunk: three chunks out, and no drain
    x = np.arange(100, dtype=np.float32)
    g, s = Graph(), blocks.VectorSink()
    hold = _HoldBack(3)
    g.chain(blocks.VectorSource(x), _CancelAfter(g.cancel_token(), 3), hold, s)
    g.run_stream(chunk_size=10, device="cpu")
    np.testing.assert_array_equal(s.data(), x[:27])


def test_torch_flush_only_at_the_true_end_of_stream(tmp_path):
    x = np.arange(100, dtype=np.float32)
    ck = str(tmp_path / "c.pkl")

    def build():
        g, s = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(x), blocks.AddConst(0.0), _HoldBack(7), s)
        return g, s

    g, s = build()
    g.run(device="cpu")
    np.testing.assert_array_equal(s.data(), x[:93])  # flush() gives nothing
    g, s = build()
    g.run_stream(chunk_size=16, device="cpu")
    np.testing.assert_array_equal(s.data(), x)  # the tail drains at the end
    g, s = build()
    g.run_stream(chunk_size=16, max_chunks=3, checkpoint_path=ck,
                 checkpoint_every=1, device="cpu")
    np.testing.assert_array_equal(s.data(), x[:41])  # a pause drains nothing
    g2, s2 = build()
    g2.run_stream(chunk_size=16, resume_from=ck, device="cpu")
    np.testing.assert_array_equal(np.concatenate([s.data(), s2.data()]), x)


class _LiveSource(blocks.VectorSource):
    """A bounded source whose live feed runs dry after ``k`` chunks."""

    def __init__(self, data, k):
        super().__init__(data)
        self.k, self.emitted = k, 0

    def emit(self, offset, n, device):
        self.emitted += 1
        return super().emit(offset, n, device)

    def exhausted(self):
        return self.emitted >= self.k


class _Counter(Block):
    """Passes samples through, counting them on the host (host_state)."""

    def __init__(self):
        self.count = 0

    def apply_chunk(self, state, x):
        self.count += x.shape[0]
        return state, x

    def host_state(self):
        return {"count": self.count}

    def restore_host_state(self, hs):
        self.count = hs["count"]


def test_torch_run_stream_exhausted_source_and_host_state(tmp_path):
    x = np.arange(100, dtype=np.float32)
    # the live source ends the stream after 3 chunks: a true end, so the
    # tail held back drains
    g, s = Graph(), blocks.VectorSink()
    g.chain(_LiveSource(x, 3), _HoldBack(4), s)
    g.run_stream(chunk_size=10, device="cpu")
    np.testing.assert_array_equal(s.data(), x[:30])
    # host-side block state rides in the checkpoint
    ck = str(tmp_path / "c.pkl")
    g, counter = Graph(), _Counter()
    g.chain(blocks.VectorSource(x), counter, blocks.NullSink())
    g.run_stream(chunk_size=16, max_chunks=2, checkpoint_path=ck,
                 checkpoint_every=2, device="cpu")
    g2, counter2 = Graph(), _Counter()
    g2.chain(blocks.VectorSource(x), counter2, blocks.NullSink())
    g2.run_stream(chunk_size=16, resume_from=ck, device="cpu")
    assert counter.count == 32 and counter2.count == 100


def _hdlc_bits():
    p1 = np.frombuffer(b"FRAME NUMBER ONE X", np.uint8)
    p2 = np.frombuffer(b"SECOND FRAME HERE!", np.uint8)
    return (np.concatenate([ops.hdlc_frame(ops.fcs_add(p)) for p in (p1, p2)]),
            [bytes(p1), bytes(p2)])


def test_torch_hdlc_streaming_no_duplicates():
    # tests/test_graph.py:206: frames spanning chunk boundaries decode once
    bits, payloads = _hdlc_bits()
    for kw in ({"chunk_size": 97}, {"chunk_size": 5}, None):
        g = Graph()
        hdlc, sink = blocks.HdlcDeframer(1, 100), blocks.PduVectorSink()
        g.chain(blocks.VectorSource(bits), hdlc, sink)
        if kw is None:
            g.run(device="cpu")
        else:
            g.run_stream(device="cpu", **kw)
        assert hdlc.stats["decoded"] == 2
        assert [bytes(np.asarray(p.data)) for p in sink.pdus()] == payloads
        assert [p.tags[0].key for p in sink.pdus()] == ["packet_pos"] * 2


def test_torch_hdlc_snapshot_restore_equals_jax():
    from rustradio_tpu.ops.hdlc import HdlcStateMachine as JMachine
    from rustradio_tpu_torch.ops.hdlc import HdlcStateMachine

    bits, payloads = _hdlc_bits()
    cut = len(bits) // 2 + 3
    j, p = JMachine(1, 100), HdlcStateMachine(1, 100)
    j.feed(bits[:cut])
    p.feed(torch.from_numpy(bits[:cut]))
    assert p.snapshot() == j.snapshot()
    # the JAX machine's snapshot goes on in the port's machine, and back
    q = HdlcStateMachine(1, 100)
    q.restore(j.snapshot())
    got = [bytes(d) for d, _ in q.feed(bits[cut:])]
    j.restore(p.snapshot())
    assert got == [bytes(d) for d, _ in j.feed(bits[cut:])] == payloads[1:]


def _nrz(n=30_000):
    t = np.arange(n)
    return np.sign(np.sin(2 * np.pi * t / 36.75 + 0.4)).astype(np.float32)


def _sync_chain(method, x):
    g, s = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.SymbolSync(36.75, 0.5, (0.5, 0.5),
                                                      method=method),
            blocks.BinarySlicer(), s)
    return g, s


@pytest.mark.parametrize("method", ["native", "events"])
def test_torch_stream_resume_through_symbol_sync(tmp_path, method):
    # tests/test_utils.py:83: a checkpoint every chunk, a crash after four,
    # a resume: the uninterrupted stream, bit for bit
    x = _nrz()
    ck = str(tmp_path / "sync.pkl")
    g1, s1 = _sync_chain(method, x)
    g1.run_stream(chunk_size=3500, device="cpu")
    g0, s0 = _sync_chain(method, x)
    g0.run(device="cpu")
    g2, s2 = _sync_chain(method, x)
    g2.run_stream(chunk_size=3500, max_chunks=4, checkpoint_path=ck,
                  checkpoint_every=1, device="cpu")
    g3, s3 = _sync_chain(method, x)
    g3.run_stream(chunk_size=3500, resume_from=ck, device="cpu")
    resumed = np.concatenate([s2.data(), s3.data()])
    assert np.array_equal(resumed, s1.data())
    assert np.array_equal(s1.data(), s0.data())
    assert len(resumed) > 700
    if method == "native":  # the JAX block's stream, bit for bit
        jg, js = JGraph(), jblocks.VectorSink()
        jg.chain(jblocks.VectorSource(x), jblocks.SymbolSync(36.75, 0.5, (0.5, 0.5)),
                 jblocks.BinarySlicer(), js)
        jg.run_stream(chunk_size=3500)
        assert np.array_equal(resumed, np.asarray(js.data()))


def test_torch_checkpoint_of_another_graph_is_refused(tmp_path):
    x = _sweep(4000, 83)
    ck = str(tmp_path / "c.pkl")
    g, _ = _dense(blocks, Graph, x)
    g.run_stream(chunk_size=1000, max_chunks=2, checkpoint_path=ck,
                 checkpoint_every=2, device="cpu")
    other, _ = _sync_chain("native", x)
    with pytest.raises(ValueError, match="different graph"):
        other.run_stream(chunk_size=1000, resume_from=ck, device="cpu")


def _ax25_chain(mod, graph_cls, audio, sync="native"):
    lp = jtaps.low_pass(FS, 1100.0, 200.0, "hamming")
    g, sink = graph_cls(), mod.PduVectorSink()
    g.chain(mod.VectorSource(audio),
            mod.FftFilterFloat(jtaps.band_pass(FS, 400.0, 2700.0, 65, "hamming")),
            mod.Hilbert(65), mod.QuadratureDemod(1.0), mod.FftFilterFloat(lp),
            mod.AddConst(-np.float32(2.0 * np.pi * 1700.0 / FS)),
            mod.SymbolSync(FS / 1200.0, 0.5, (1 / 6,) * 6, method=sync),
            mod.BinarySlicer(), mod.NrziDecode(), mod.HdlcDeframer(10, 1500),
            sink)
    return g, sink


def _payloads(sink):
    return [bytes(np.asarray(p.data)) for p in sink.pdus()]


def test_torch_resumes_a_jax_checkpoint(tmp_path):
    # the JAX package's run_stream writes a checkpoint mid-stream (inside
    # the second frame); the port resumes it and decodes the rest: block
    # states (filter tails, the discriminator's sample, the native sync's
    # dict, NRZI's bit, the HDLC snapshot with its partial frame) cross over
    payloads = [b"FIRST FRAME OF THE CHECKPOINT", b"SECOND FRAME, CUT IN TWO",
                b"THIRD FRAME AFTER THE RESUME"]
    audio = np.concatenate([make_afsk(p, fs=FS) for p in payloads])
    chunk = len(audio) // 5 + 1
    ck = str(tmp_path / "jax.pkl")
    jg, js = _ax25_chain(jblocks, JGraph, audio)
    jg.run_stream(chunk_size=chunk, max_chunks=2, checkpoint_path=ck,
                  checkpoint_every=2)
    assert _payloads(js) == payloads[:1]
    g, s = _ax25_chain(blocks, Graph, audio)
    g.run_stream(chunk_size=chunk, resume_from=ck, device="cpu")
    assert _payloads(js) + _payloads(s) == payloads
    # the whole stream in the port alone decodes the same list
    g, s = _ax25_chain(blocks, Graph, audio)
    g.run_stream(chunk_size=chunk, device="cpu")
    assert _payloads(s) == payloads


def test_torch_resumes_a_jax_checkpoint_dense_chain(tmp_path):
    # the dense float chain: JAX runs two chunks and checkpoints, the port
    # resumes; against JAX's uninterrupted stream at the chain's 1e-4
    x = _sweep(8000, 84)
    ck = str(tmp_path / "jax.pkl")
    jg, js = _dense(jblocks, JGraph, x)
    jg.run_stream(chunk_size=2000, max_chunks=2, checkpoint_path=ck,
                  checkpoint_every=2)
    g, s = _dense(blocks, Graph, x)
    g.run_stream(chunk_size=2000, resume_from=ck, device="cpu")
    got = np.concatenate([np.asarray(js.data()), s.data()])
    g, s = _dense(blocks, Graph, x)
    g.run(device="cpu")
    np.testing.assert_allclose(got, s.data(), atol=1e-4, rtol=0)


def test_torch_run_stream_without_a_card_raises_and_names_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, s = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(np.ones(64, np.float32)), blocks.AddConst(1.0), s)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        g.run_stream(chunk_size=16)
    g.run_stream(chunk_size=16, device="cpu")
    np.testing.assert_array_equal(s.data(), np.full(64, 2.0))
    with pytest.raises(ValueError, match="no sources"):
        Graph().run_stream(device="cpu")


def test_torch_stream_blocks_chunked_equal_offline():
    # each new block's chunk form over uneven chunks against its offline
    # form: the filters and Hilbert within f32 rounding, the rest exactly
    rng = np.random.RandomState(85)
    x = torch.from_numpy(rng.randn(5000).astype(np.float32))
    xc = torch.complex(x, torch.from_numpy(rng.randn(5000).astype(np.float32)))
    ctaps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    cases = [
        (blocks.FftFilterFloat(rng.randn(65).astype(np.float32)), x, 1e-5),
        (blocks.FftFilterFloat(np.ones(1, np.float32)), x, 0.0),
        (blocks.FftFilter(ctaps), xc, 1e-4),
        (blocks.FftFilter(np.real(ctaps)), xc, 1e-5),
        (blocks.Hilbert(65), x, 1e-5),
        (blocks.AddConst(2.5), x, 0.0),
        (blocks.MultiplyConst(-1.5), xc, 0.0),
        (blocks.BinarySlicer(), x, 0.0),
        (blocks.NrziDecode(), (x > 0).to(torch.uint8), 0.0),
    ]
    for blk, inp, tol in cases:
        want = blk.apply(inp)
        st, parts = blk.init_state(), []
        for a, b in ((0, 1), (1, 700), (700, 700), (700, 3001), (3001, 5000)):
            st, y = blk.apply_chunk(st, inp[a:b])
            parts.append(y)
        got = torch.cat(parts)
        assert got.shape == want.shape, blk.name()
        if tol:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                       err_msg=blk.name())
        else:
            assert torch.equal(got, want), blk.name()
    # against the JAX blocks' offline forms
    xn = x.numpy()
    for mine, theirs, inp, tol in (
            (blocks.Hilbert(65), jblocks.Hilbert(65), xn, 1e-5),
            (blocks.FftFilter(ctaps), jblocks.FftFilter(ctaps), xc.numpy(), 1e-4),
            (blocks.BinarySlicer(), jblocks.BinarySlicer(), xn, 0.0)):
        got = mine.apply(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(got, np.asarray(theirs.apply(inp)), atol=tol)
    np.testing.assert_allclose(
        blocks.FftFilterFloat(jtaps.low_pass(FS, 1100.0, 200.0)).apply(x).numpy(),
        np.asarray(jops.filter_float(xn, jtaps.low_pass(FS, 1100.0, 200.0))),
        atol=1e-5)
