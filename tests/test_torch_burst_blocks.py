"""The port's burst, G3RUH, rate and KISS blocks against the JAX package's:
the BurstTagger -> StreamToPdu -> PduToStream graph, StreamToPdu streamed
with bursts across chunk edges and a tail clipped by the end of the stream
(the drain), a JAX checkpoint taken mid-burst and resumed by the port,
Midpointer/Wpcr, the stateful stream blocks streamed against offline and
JAX, Delay's cases, and the KISS framing.  The JAX side runs on the CPU,
the port on the kernels' plain versions; inputs are seeded numpy arrays.
"""

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.streams import Pdu as JPdu
from rustradio_tpu.streams import Tag as JTag
from rustradio_tpu_torch import blocks
from rustradio_tpu_torch.convert import state_from_jax
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.ops.wpcr import midpoint, wpcr_numpy
from rustradio_tpu_torch.streams import Pdu, Tag


def _run(g, chunk=None, **kw):
    """The JAX graph (no ``device``) or the port's, offline or streamed."""
    if isinstance(g, Graph):
        kw["device"] = "cpu"
    if chunk is None:
        g.run(**kw)
    else:
        g.run_stream(chunk_size=chunk, **kw)


def _pdus(sink):
    return [np.asarray(p.data.numpy() if torch.is_tensor(p.data) else p.data)
            for p in sink.pdus()]


def test_torch_burst_pipeline_graph_matches_jax():
    # power-gated burst -> PDU -> back to stream (tests/test_graph.py:156)
    rng = np.random.RandomState(4)
    data = np.zeros(1000, np.float32)
    data[300:400] = rng.randn(100).astype(np.float32) + 3
    trigger = np.zeros(1000, np.float32)
    trigger[295:405] = 1.0
    outs = []
    for mod, G in ((blocks, Graph), (jblocks, JGraph)):
        g = G()
        dsrc = g.add(mod.VectorSource(data))
        tsrc = g.add(mod.VectorSource(trigger))
        bt = g.add(mod.BurstTagger(0.5, "burst"), dsrc, tsrc)
        pdu = g.add(mod.StreamToPdu("burst", 10_000, 0), bt)
        back = g.add(mod.PduToStream(), pdu)
        sink = g.add(mod.VectorSink(), back)
        _run(g)
        outs.append((np.asarray(sink.block.data()),
                     [(t.pos, t.key) for t in sink.block.tags()]))
    np.testing.assert_array_equal(outs[0][0], data[295:405])
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


def _burst_graph(mod, G, data, trigger, tail, interior=()):
    g = G()
    dsrc = g.add(mod.VectorSource(data, tags=list(interior)))
    tsrc = g.add(mod.VectorSource(trigger))
    bt = g.add(mod.BurstTagger(0.5, "burst"), dsrc, tsrc)
    pdu = g.add(mod.StreamToPdu("burst", 10_000, tail), bt)
    sink = g.add(mod.PduVectorSink(), pdu)
    return g, sink.block


def _bursts():
    rng = np.random.RandomState(7)
    data = rng.randn(2000).astype(np.float32)
    trigger = np.zeros(2000, np.float32)
    # bursts straddling the chunk edges of 64/128/333; the last one's tail
    # runs past the end of the stream, which the drain files clipped
    for a, b in [(50, 80), (120, 140), (250, 400), (500, 660), (1000, 1010),
                 (1300, 1500), (1950, 1990)]:
        trigger[a:b] = 1.0
    return data, trigger


@pytest.mark.parametrize("tail", [0, 13])
@pytest.mark.parametrize("chunk", [64, 333])
def test_torch_stream_to_pdu_streamed_equals_offline_and_jax(tail, chunk):
    data, trigger = _bursts()
    interior = [(270, "mark", 1), (1400, "mark", 2)]
    got = []
    for mod, G, T in ((blocks, Graph, Tag), (jblocks, JGraph, JTag)):
        for c in (None, chunk):
            g, s = _burst_graph(mod, G, data, trigger, tail,
                                [T(*t) for t in interior])
            _run(g, c)
            got.append((_pdus(s), [[(t.pos, t.key, t.val) for t in p.tags]
                                   for p in s.pdus()]))
    want = got[3]  # the JAX package streamed
    assert len(want[0]) == 7
    # the clipped tail (the burst ending at 1990, tail 13 past 2000) is
    # filed by the drain, 50 samples
    assert len(want[0][-1]) == (40 + 10 if tail else 40)
    for pdus, tags in got[:3]:
        assert len(pdus) == len(want[0])
        for a, b in zip(pdus, want[0]):
            np.testing.assert_array_equal(a, b)
        assert tags == want[1]


def _resume_graph(mod, G, T, x):
    tags = [T(100, "burst", True), T(150, "mark", 7), T(430, "burst", False)]
    g = G()
    s = mod.PduVectorSink()
    g.chain(mod.VectorSource(x, tags=tags),
            mod.StreamToPdu("burst", max_size=100_000, tail=100), s)
    return g, s


@pytest.mark.parametrize("pause_chunks", [1, 3, 4])
def test_torch_resumes_a_jax_checkpoint_taken_mid_burst(tmp_path, pause_chunks):
    # the JAX package pauses inside the burst (chunk 1), in its clipped
    # tail (chunk 3) or at the end of the stream (chunk 4: the port's
    # resumed run sees no chunk, and its drain reads the restored state;
    # the paused JAX run, at its end, has drained it too, as the JAX
    # package's own test_resume_flushes_clipped_burst shows)
    x = np.arange(500, dtype=np.float32)
    ck = str(tmp_path / "mid.pkl")
    jg, js = _resume_graph(jblocks, JGraph, JTag, x)
    jg.run_stream(chunk_size=125)
    want = _pdus(js)
    assert len(want) == 1 and len(want[0]) == 400
    jg, js1 = _resume_graph(jblocks, JGraph, JTag, x)
    jg.run_stream(chunk_size=125, max_chunks=pause_chunks, checkpoint_path=ck,
                  checkpoint_every=pause_chunks)
    assert len(js1.pdus()) == (pause_chunks == 4)
    g, s = _resume_graph(blocks, Graph, Tag, x)
    g.run_stream(chunk_size=125, resume_from=ck, device="cpu")
    assert len(_pdus(s)) == 1
    np.testing.assert_array_equal(_pdus(s)[0], want[0])
    ptags = s.pdus()[0].tags
    assert any(isinstance(t, Tag) and t.key == "mark" and t.pos == 50
               for t in ptags), ptags


def test_torch_state_from_jax_maps_an_open_burst():
    jb = jblocks.StreamToPdu("burst", 100, 3)
    st = jb.init_state()
    jb.set_tags([JTag(2, "burst", True), JTag(4, "mark", "x")])
    st, _ = jb.apply_chunk(st, np.arange(8, dtype=np.float32))
    got = state_from_jax(st, device="cpu")
    assert got["mode"] == blocks.StreamToPdu.PACKET
    assert torch.equal(got["buf"], torch.arange(2, 8, dtype=torch.float32))
    assert got["tags"] == [Tag(2, "mark", "x")]
    assert type(got["tags"][0]) is Tag


def _make_burst(rng, nbits, sps, noise=0.05):
    bits = rng.randint(0, 2, nbits) * 2.0 - 1.0
    x = np.repeat(bits, sps).astype(np.float32)
    return x + rng.randn(len(x)).astype(np.float32) * noise


def test_torch_midpointer_wpcr_blocks():
    # tests/test_wpcr_batch.py:67, held against the numpy golden model
    rng = np.random.RandomState(2)
    bursts = [_make_burst(rng, 50, 8) for _ in range(5)]
    mid = blocks.Midpointer()
    wp = blocks.Wpcr(samp_rate=50_000.0)
    out = wp.apply(mid.apply([Pdu(torch.from_numpy(b)) for b in bursts]))
    assert len(out) == 5
    for b, p in zip(bursts, out):
        syms, sps, _ = wpcr_numpy(midpoint(torch.from_numpy(b))[0].numpy())
        np.testing.assert_array_equal(p.data.numpy(), syms)
        tag_sps = [t.val for t in p.tags if t.key == "sps"][0]
        assert tag_sps == pytest.approx(sps, abs=1e-9)
        assert tag_sps == pytest.approx(1 / 8, rel=0.05)
        assert any(t.key == "frequency" for t in p.tags)


def _stream_chain(mod, G, x, make):
    g, sink = G(), mod.VectorSink()
    g.chain(mod.VectorSource(x), make(mod), sink)
    return g, sink


_BITS = np.random.RandomState(30).randint(0, 2, 1500).astype(np.uint8)
_F32 = np.random.RandomState(31).randn(1500).astype(np.float32)
_C64 = (_F32 + 1j * np.random.RandomState(32).randn(1500)).astype(np.complex64)

# (block, input, tolerance against JAX): bit streams and gathers are exact;
# the IIR runs in another order (blocked closed form against an associative
# scan): 1e-5 at |x| ~ 3; the VCO's phase is a float64 sum here and an
# f32 sum in the JAX package: 1e-4 over 1500 steps of |k x| < 0.4 rad
_STREAM_CASES = {
    "Scrambler": (lambda m: m.Scrambler.g3ruh(), _BITS, 0),
    "Descrambler": (lambda m: m.Descrambler.g3ruh(), _BITS, 0),
    "NrziEncode": (lambda m: m.NrziEncode(), _BITS, 0),
    "Vco": (lambda m: m.Vco(0.1), _F32, 1e-4),
    "SinglePoleIirFilter": (lambda m: m.SinglePoleIirFilter(0.05), _F32, 1e-5),
    "IqBalance": (lambda m: m.IqBalance(0.02), _C64, 1e-5),
    "RationalResampler": (lambda m: m.RationalResampler(5, 3), _C64, 0),
    "FastFM": (lambda m: m.FastFM(), _C64, 1e-6),
    "ComplexToMag2": (lambda m: m.ComplexToMag2(), _C64, 1e-6),
    "Skip": (lambda m: m.Skip(77), _F32, 0),
    "Head": (lambda m: m.Head(900), _F32, 0),
}


@pytest.mark.parametrize("name", sorted(_STREAM_CASES))
def test_torch_stream_block_streamed_equals_offline_and_jax(name):
    make, x, tol = _STREAM_CASES[name]
    g, s = _stream_chain(blocks, Graph, x, make)
    _run(g)
    offline = s.data()
    g, s = _stream_chain(blocks, Graph, x, make)
    _run(g, 128)
    streamed = s.data()
    jg, js = _stream_chain(jblocks, JGraph, x, make)
    jg.run_stream(chunk_size=128)
    want = np.asarray(js.data())
    assert offline.shape == streamed.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(streamed, offline)
        np.testing.assert_array_equal(streamed, want)
    else:
        np.testing.assert_allclose(streamed, offline, atol=tol, rtol=0)
        np.testing.assert_allclose(streamed, want, atol=tol, rtol=0)


def test_torch_scrambler_descrambler_round_trip():
    # the scrambler emits its oldest register bit, so the chain is a 17-bit
    # delay (reference descrambler.rs test long_random_nrzi_g3ruh)
    g, sink = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(_BITS), blocks.Scrambler.g3ruh(),
            blocks.NrziEncode(), blocks.NrziDecode(),
            blocks.Descrambler.g3ruh(), sink)
    g.run_stream(chunk_size=64, device="cpu")
    np.testing.assert_array_equal(sink.data()[17:], _BITS[: len(_BITS) - 17])


# ---- Delay: the cases of tests/test_delay.py

def _delay_run(mod, G, block, data, chunk=None, tags=()):
    g = G()
    sink = g.add(mod.VectorSink(), g.add(block, g.add(mod.VectorSource(
        data, tags=list(tags)))))
    _run(g, chunk)
    return sink.block


@pytest.mark.parametrize("n, setn, data, want", [
    (0, None, [1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),
    (1, None, [1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 3.0]),
    (1, 2, [1, 2], [0, 0, 1, 2]),
    (3, 1, [1, 2], [0, 1, 2]),
])
def test_torch_delay_cases_match_jax(n, setn, data, want):
    data = np.asarray(data, np.float32 if isinstance(data[0], float) else np.int32)
    got = []
    for mod, G in ((blocks, Graph), (jblocks, JGraph)):
        d = mod.Delay(n, dynamic=setn is not None)
        if setn is not None:
            d.set_delay(setn)
        got.append(np.asarray(_delay_run(mod, G, d, data).data()))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[0], got[1])


def test_torch_delay_dynamic_chunks():
    # reduced twice (accumulated skip), a mid-stream decrease and increase
    cap = 64
    data = torch.arange(cap, dtype=torch.int32)
    d = blocks.Delay(cap + 10, dynamic=True)
    state = d.init_state()
    state, out = d.apply_chunk(state, data[:0])
    assert torch.equal(out, torch.zeros(cap + 10, dtype=torch.int32))
    d.set_delay(cap - 1)
    d.set_delay(cap - 2)
    state, out = d.apply_chunk(state, data)
    assert torch.equal(out, data[12:])
    data = torch.arange(16, dtype=torch.int32)
    d = blocks.Delay(4, dynamic=True)
    state = d.init_state()
    state, out1 = d.apply_chunk(state, data[:8])
    assert torch.equal(out1, torch.cat([torch.zeros(4, dtype=torch.int32), data[:8]]))
    d.set_delay(1)
    state, out2 = d.apply_chunk(state, data[8:])
    assert torch.equal(out2, data[11:])
    d = blocks.Delay(1, dynamic=True)
    state = d.init_state()
    state, out1 = d.apply_chunk(state, data[:4])
    assert out1.tolist() == [0, 0, 1, 2, 3]
    d.set_delay(3)
    state, out2 = d.apply_chunk(state, data[4:8])
    assert out2.tolist() == [0, 0, 4, 5, 6, 7]
    assert d.domain == "host"
    with pytest.raises(ValueError):
        blocks.Delay(3).set_delay(1)


def test_torch_delay_tags_streamed_and_fused():
    data = np.arange(128, dtype=np.float32)
    # a tag in the last `delay` samples of a chunk rides the carried tail
    s = _delay_run(blocks, Graph, blocks.Delay(10), data, 64,
                   [Tag(58, "mark", 7)])
    marks = [t for t in s.tags() if t.key == "mark"]
    assert len(marks) == 1 and marks[0].pos == 68, marks
    s = _delay_run(blocks, Graph, blocks.Delay(3), data[:8], None,
                   [Tag(2, "mark", 1)])
    assert any(t.key == "mark" and t.pos == 5 for t in s.tags())
    a = _delay_run(blocks, Graph, blocks.Delay(7), data[:100]).data()
    b = _delay_run(blocks, Graph, blocks.Delay(7), data[:100], 13).data()
    np.testing.assert_array_equal(a, b)
    # between two device blocks the static delay joins ONE segment
    g = Graph()
    sink = g.add(blocks.VectorSink(), g.add(blocks.MultiplyConst(2.0), g.add(
        blocks.Delay(4), g.add(blocks.AddConst(1.0),
                               g.add(blocks.VectorSource(data[:8]))))))
    assert any(len(seg) == 3 for seg in g._segments().values())
    g.run(device="cpu")
    np.testing.assert_allclose(sink.block.data(), np.concatenate(
        [np.zeros(4, np.float32), data[:8] + 1]) * 2)


def test_torch_delay_pause_and_resume(tmp_path):
    # a max_chunks pause keeps the tail; the resumed run drains it once
    ck = str(tmp_path / "ck.pkl")
    data = np.arange(40, dtype=np.float32)
    want = _delay_run(blocks, Graph, blocks.Delay(5), data, 10).data()
    np.testing.assert_array_equal(want, np.concatenate([np.zeros(5), data]))
    g = Graph()
    s2 = g.add(blocks.VectorSink(), g.add(blocks.Delay(5),
                                          g.add(blocks.VectorSource(data))))
    g.run_stream(chunk_size=10, max_chunks=2, checkpoint_path=ck,
                 checkpoint_every=2, device="cpu")
    assert len(s2.block.data()) == 20
    g = Graph()
    s3 = g.add(blocks.VectorSink(), g.add(blocks.Delay(5),
                                          g.add(blocks.VectorSource(data))))
    g.run_stream(chunk_size=10, resume_from=ck, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([s2.block.data(), s3.block.data()]), want)


# ---- KISS framing: the cases of tests/test_fuzz_parsers.py:49

def _chunks(data, sizes):
    out, i = [], 0
    for s in sizes:
        out.append(data[i : i + s])
        i += s
    if i < len(data):
        out.append(data[i:])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_kiss_frame_and_decode_match_jax(seed):
    rng = np.random.RandomState(0xFADE + seed)
    for _ in range(20):
        data = rng.randint(0, 256, rng.randint(1, 600)).astype(np.uint8)
        # some valid frames too: escapes and FENDs inside
        frames = [rng.randint(0, 256, rng.randint(1, 40)).astype(np.uint8)
                  for _ in range(3)]
        enc = blocks.KissEncode().apply([Pdu(f) for f in frames])
        jenc = jblocks.KissEncode().apply([JPdu(f) for f in frames])
        for a, b in zip(enc, jenc):
            np.testing.assert_array_equal(a.data, np.asarray(b.data))
        data = np.concatenate([data] + [p.data for p in enc])
        sizes = rng.randint(1, 64, 8)
        got = []
        for mod in (blocks, jblocks):
            kf = mod.KissFrame(max_len=256)
            state = kf.init_state()
            out = []
            for c in _chunks(data, sizes):
                state, o = kf.apply_chunk(state, c)
                out.extend(o)
            dec = mod.KissDecode().apply(out)
            got.append(([bytes(np.asarray(p.data)) for p in out],
                        [(bytes(np.asarray(p.data)),
                          [(t.key, t.val) for t in p.tags]) for p in dec]))
        assert got[0] == got[1]
        assert [bytes(f) for f in frames] == [d for d, _ in got[0][1]][-3:]


def test_torch_hdlc_framer_and_fcs_adder_match_jax():
    payload = np.frombuffer(b"GRAPH HDLC TEST", np.uint8)
    a = blocks.HdlcFramer().apply(blocks.FcsAdder().apply([Pdu(payload)]))
    b = jblocks.HdlcFramer().apply(jblocks.FcsAdder().apply([JPdu(payload)]))
    np.testing.assert_array_equal(a[0].data, np.asarray(b[0].data))
