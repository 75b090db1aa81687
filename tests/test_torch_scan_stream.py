"""The port's batched streaming runner (``Graph.run_stream(scan_chunks=)``)
against the JAX package's, on the same graphs and seeded numpy inputs:
the JAX package's scan tests mirrored (tags, fan-out, checkpoint + resume,
the random and complex chains, StreamToPdu), a JAX checkpoint taken under
the scan runner resumed by the port, the batch boundaries and the batch
hooks, the CUDA-graph path of the runner on the CPU (the capture replaced
by a stand-in that runs the recorded function at each replay, so that the
runner's staging, state carry and counters are exercised here), and the
table of every block class's ``graph_capturable``.

Tolerances: the port's scan run is held bit for bit to its own per-chunk
run; against the JAX package the f32 chains are held at the JAX test's
1e-5 (the same f32 filters in another summation order), tags and PDUs
exactly.  The JAX side runs on the CPU, the port on the kernels' plain
versions.
"""

import inspect
import pickle

import numpy as np
import pytest
import torch
# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process, ~2 s once: imported with this module, so that
# each test's time is its own.
import torch._dynamo  # noqa: F401

import rustradio_tpu_torch.graph as graph_mod
from rustradio_tpu import blocks as jblocks
from rustradio_tpu.blocks.base import SourceBlock as JSourceBlock
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.streams import Tag as JTag
from rustradio_tpu_torch import blocks, hw
from rustradio_tpu_torch.blocks.base import Block, SourceBlock
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.streams import Tag

CPU = "cpu"


def _run(graph, **kw):
    if isinstance(graph, Graph):
        graph.run_stream(device=CPU, **kw)
    else:
        graph.run_stream(**kw)


# ---- the JAX package's scan tests, both packages


def _tags_graph(mod, graph_cls, tag_cls, x):
    tags = [tag_cls(500, "a", 1), tag_cls(1010, "b", 2), tag_cls(3900, "c", 3)]
    g, sink = graph_cls(), mod.VectorSink()
    g.chain(mod.VectorSource(x, tags=tags),
            mod.FirFilter(np.asarray([0.25, 0.5, 0.25], np.float32)),
            mod.Delay(40), sink)
    return g, sink


def _abc(sink):
    return [(t.pos, t.key, t.val) for t in sink.tags() if t.key in "abc"]


@pytest.mark.parametrize("scan", [None, 4])
def test_torch_scan_runner_preserves_tags(scan):
    # tests/test_graph.py::test_scan_runner_preserves_tags
    x = np.arange(4000, dtype=np.float32)
    g, s0 = _tags_graph(blocks, Graph, Tag, x)
    _run(g, chunk_size=512)
    g, s1 = _tags_graph(blocks, Graph, Tag, x)
    _run(g, chunk_size=512, scan_chunks=scan)
    jg, js = _tags_graph(jblocks, JGraph, JTag, x)
    jg.run_stream(chunk_size=512, scan_chunks=scan)
    assert np.array_equal(s1.data(), s0.data())
    assert _abc(s1) == _abc(s0) == _abc(js) and len(_abc(s1)) == 3
    np.testing.assert_allclose(s1.data(), np.asarray(js.data()), atol=1e-5, rtol=0)


def _fanout(mod, graph_cls, x):
    g = graph_cls()
    src = g.add(mod.VectorSource(x))
    f1 = g.add(mod.FirFilter(np.asarray([0.5, 0.5], np.float32)), src)
    s1 = g.add(mod.VectorSink(), f1)
    f2 = g.add(mod.MultiplyConst(2.0), f1)
    s2 = g.add(mod.VectorSink(), f2)
    return g, s1.block, s2.block


def test_torch_scan_runner_fanout_graph():
    # tests/test_graph.py::test_scan_runner_fanout_graph
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    g, a0, b0 = _fanout(blocks, Graph, x)
    _run(g, chunk_size=512)
    g, a1, b1 = _fanout(blocks, Graph, x)
    _run(g, chunk_size=512, scan_chunks=4)
    jg, ja, jb = _fanout(jblocks, JGraph, x)
    jg.run_stream(chunk_size=512, scan_chunks=4)
    assert np.array_equal(a1.data(), a0.data())
    assert np.array_equal(b1.data(), b0.data())
    np.testing.assert_allclose(a1.data(), np.asarray(ja.data()), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b1.data(), np.asarray(jb.data()), atol=1e-6, rtol=0)


def _ck_graph(mod, graph_cls, x, sink):
    g = graph_cls()
    g.chain(mod.VectorSource(x),
            mod.FirFilter(np.asarray([0.25, 0.5, 0.25], np.float32)),
            mod.Delay(7), mod.MultiplyConst(0.5), sink)
    return g


def test_torch_scan_runner_composes_with_checkpoint_resume(tmp_path):
    # tests/test_graph.py::test_scan_runner_composes_with_checkpoint_resume,
    # and the offsets both packages checkpoint at
    x = np.random.RandomState(11).randn(8192).astype(np.float32)
    s_ref = blocks.VectorSink()
    _run(_ck_graph(blocks, Graph, x, s_ref), chunk_size=512)
    ck, jck = str(tmp_path / "scan.ckpt"), str(tmp_path / "jscan.ckpt")
    s1 = blocks.VectorSink()
    _run(_ck_graph(blocks, Graph, x, s1), chunk_size=512, scan_chunks=4,
         max_chunks=8, checkpoint_path=ck, checkpoint_every=4)
    s2 = blocks.VectorSink()
    _run(_ck_graph(blocks, Graph, x, s2), chunk_size=512, scan_chunks=4,
         resume_from=ck)
    got = np.concatenate([s1.data(), s2.data()])
    assert np.array_equal(got, s_ref.data())
    jg = _ck_graph(jblocks, JGraph, x, jblocks.VectorSink())
    jg.run_stream(chunk_size=512, scan_chunks=4, max_chunks=8,
                  checkpoint_path=jck, checkpoint_every=4)
    with open(ck, "rb") as f, open(jck, "rb") as g:
        assert pickle.load(f)["offset"] == pickle.load(g)["offset"] == 8 * 512


@pytest.mark.parametrize("every", [3, 5])
def test_torch_scan_checkpoint_offsets_equal_jax(tmp_path, every):
    # a batch that crosses a multiple of checkpoint_every saves after it,
    # in both packages: the same offsets, chunk counts 1, 5, 9, 13, 16
    x = np.random.RandomState(3).randn(16 * 256).astype(np.float32)
    offsets = {}
    for name, mod, graph_cls in (("port", blocks, Graph),
                                 ("jax", jblocks, JGraph)):
        saved = []
        g = _ck_graph(mod, graph_cls, x, mod.VectorSink())
        real = g._save_checkpoint

        def save(path, states, offset, real=real, saved=saved):
            saved.append(offset)
            real(path, states, offset)

        g._save_checkpoint = save
        _run(g, chunk_size=256, scan_chunks=4,
             checkpoint_path=str(tmp_path / f"{name}.ckpt"), checkpoint_every=every)
        offsets[name] = saved
    assert offsets["port"] == offsets["jax"] and offsets["port"]


def test_torch_scan_resumes_a_jax_scan_checkpoint(tmp_path):
    # a checkpoint the JAX package wrote under its scan runner, resumed by
    # the port's scan runner at the same offset
    x = np.random.RandomState(12).randn(8192).astype(np.float32)
    jck = str(tmp_path / "j.ckpt")
    js1 = jblocks.VectorSink()
    _ck_graph(jblocks, JGraph, x, js1).run_stream(
        chunk_size=512, scan_chunks=4, max_chunks=8, checkpoint_path=jck,
        checkpoint_every=4)
    s2 = blocks.VectorSink()
    _run(_ck_graph(blocks, Graph, x, s2), chunk_size=512, scan_chunks=4,
         resume_from=jck)
    s_ref = blocks.VectorSink()
    _run(_ck_graph(blocks, Graph, x, s_ref), chunk_size=512)
    with open(jck, "rb") as f:
        assert pickle.load(f)["offset"] == 8 * 512
    got = np.concatenate([np.asarray(js1.data()), s2.data()])
    np.testing.assert_allclose(got, s_ref.data(), atol=1e-6, rtol=0)


def _random_chain(mod, rng):
    """tests/test_stream_equivalence_fuzz.py::_random_chain, for either
    package: the block factories of one seeded chain."""
    factories = []
    for _ in range(rng.randint(2, 6)):
        kind = rng.randint(0, 8)
        if kind == 0:
            c = float(rng.randn())
            factories.append(lambda c=c: mod.AddConst(c))
        elif kind == 1:
            c = float(rng.randn()) or 1.0
            factories.append(lambda c=c: mod.MultiplyConst(c))
        elif kind == 2:
            d = int(rng.randint(0, 20))
            factories.append(lambda d=d: mod.Delay(d))
        elif kind == 3:
            nt = int(rng.randint(1, 12))
            t = tuple(rng.randn(nt).astype(np.float32).tolist())
            factories.append(lambda t=t: mod.FirFilter(np.asarray(t, np.float32)))
        elif kind == 4:
            i, d = int(rng.randint(1, 5)), int(rng.randint(1, 5))
            factories.append(lambda i=i, d=d: mod.RationalResampler(i, d))
        elif kind == 5:
            s = int(rng.randint(0, 50))
            factories.append(lambda s=s: mod.Skip(s))
        elif kind == 6:
            a = float(rng.uniform(0.01, 0.5))
            factories.append(lambda a=a: mod.SinglePoleIirFilter(a))
        else:
            factories.append(lambda: mod.Inspect(lambda x: None))
    return factories


def _chain_run(mod, graph_cls, factories, data, chunk, scan):
    g = graph_cls()
    node = g.add(mod.VectorSource(data))
    for f in factories:
        node = g.add(f(), node)
    sink = g.add(mod.VectorSink(), node)
    _run(g, chunk_size=chunk, scan_chunks=scan)
    return np.asarray(sink.block.data())


# seed 9's chain costs the JAX package 4 s of scan compiles
_SEEDS = [pytest.param(s, scan, marks=pytest.mark.slow) if (s, scan) == (9, 4)
          else (s, scan) for s in range(12) for scan in (None, 4)]


@pytest.mark.parametrize("seed,scan", _SEEDS)
def test_torch_scan_random_chain_equals_jax(seed, scan):
    # tests/test_stream_equivalence_fuzz.py::test_random_chain_stream_equals_offline
    rng = np.random.RandomState(seed)
    factories = _random_chain(blocks, rng)
    jrng = np.random.RandomState(seed)
    jfactories = _random_chain(jblocks, jrng)
    data = rng.randn(rng.randint(500, 3000)).astype(np.float32)
    chunk = int(rng.choice([17, 64, 129, 333, 1000]))
    got = _chain_run(blocks, Graph, factories, data, chunk, scan)
    per_chunk = _chain_run(blocks, Graph, factories, data, chunk, None)
    want = _chain_run(jblocks, JGraph, jfactories, data, chunk, scan)
    assert np.array_equal(got, per_chunk)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _complex_chain(mod, graph_cls, data, t, scan):
    g, sink = graph_cls(), mod.VectorSink()
    g.chain(mod.VectorSource(data), mod.FirFilter(t.astype(np.complex64)),
            mod.MultiplyConst(0.5), mod.ComplexToMag2(), sink)
    _run(g, chunk_size=111, scan_chunks=scan)
    return np.asarray(sink.data())


@pytest.mark.parametrize("scan", [None, 3])
@pytest.mark.parametrize("seed", range(4))
def test_torch_scan_complex_chain_equals_jax(seed, scan):
    # tests/test_stream_equivalence_fuzz.py::test_random_complex_chain_stream_equals_offline
    rng = np.random.RandomState(1000 + seed)
    data = (rng.randn(2000) + 1j * rng.randn(2000)).astype(np.complex64)
    t = rng.randn(int(rng.randint(1, 9))).astype(np.float32)
    got = _complex_chain(blocks, Graph, data, t, scan)
    assert np.array_equal(got, _complex_chain(blocks, Graph, data, t, None))
    np.testing.assert_allclose(got, _complex_chain(jblocks, JGraph, data, t, scan),
                               atol=1e-5, rtol=0)


def _pdu_graph(mod, graph_cls, tag_cls, x):
    tags = [tag_cls(700, "burst", True), tag_cls(1200, "burst", False),
            tag_cls(2900, "burst", True), tag_cls(4400, "burst", False)]
    g, sink = graph_cls(), mod.PduVectorSink()
    g.chain(mod.VectorSource(x, tags=tags), mod.MultiplyConst(2.0),
            mod.StreamToPdu("burst", max_size=100_000, tail=10), sink)
    return g, sink


def test_torch_stream_to_pdu_under_scan_runner():
    # tests/test_streaming_pdu.py::test_stream_to_pdu_under_scan_runner
    x = np.arange(6000, dtype=np.float32)
    runs = []
    for scan in (None, 4):
        g, sink = _pdu_graph(blocks, Graph, Tag, x)
        _run(g, chunk_size=512, scan_chunks=scan)
        runs.append(sink.pdus())
    jg, js = _pdu_graph(jblocks, JGraph, JTag, x)
    jg.run_stream(chunk_size=512, scan_chunks=4)
    assert len(runs[0]) == len(runs[1]) == len(js.pdus()) == 2
    for a, b, c in zip(runs[0], runs[1], js.pdus()):
        assert np.array_equal(np.asarray(a.data), np.asarray(b.data))
        assert np.array_equal(np.asarray(b.data), np.asarray(c.data))


# ---- batch boundaries and the batch hooks


class _BatchSource(SourceBlock):
    """Counts its calls: ``emit`` chunk by chunk, ``emit_batch`` a batch."""

    graph_capturable = False  # a source

    def __init__(self, n):
        self.data = np.arange(n, dtype=np.float32)
        self.calls = []

    def total_len(self):
        return len(self.data)

    def emit(self, offset, n, device):
        self.calls.append(("emit", offset, 1))
        return torch.from_numpy(self.data[offset:offset + n]).to(device)

    def emit_batch(self, offset, chunk, nb, device):
        self.calls.append(("batch", offset, nb))
        return torch.from_numpy(self.data[offset:offset + nb * chunk]).to(
            device).view(nb, chunk)


class _JBatchSource(JSourceBlock):
    def __init__(self, n):
        self.data = np.arange(n, dtype=np.float32)
        self.calls = []

    def total_len(self):
        return len(self.data)

    def emit(self, offset, n):
        self.calls.append(("emit", offset, 1))
        return self.data[offset:offset + n]

    def emit_batch(self, offset, chunk, nb):
        self.calls.append(("batch", offset, nb))
        return self.data[offset:offset + nb * chunk].reshape(nb, chunk)


class _BatchSink(Block):
    """Takes a batch in one call; counts its calls."""

    graph_capturable = False  # a sink
    n_out = 0
    domain = "device"

    def __init__(self):
        self.calls, self.chunks = [], []

    def apply(self, x):
        self.calls.append(1)
        self.chunks.append(x.cpu().numpy())
        return ()

    def accept_batch(self, stacked):
        self.calls.append(stacked.shape[0])
        self.chunks.extend(stacked.cpu().numpy())


def _expected_nb(total, b, max_chunks):
    """The JAX runner's batch rule: the call's first chunk alone, then
    batches of min(B, full chunks left, max_chunks left) while >= 2."""
    out, done = [], 0
    while done < total and (max_chunks is None or done < max_chunks):
        nb = 0
        if done >= 1:
            nb = min(b, total - done)
            if max_chunks is not None:
                nb = min(nb, max_chunks - done)
        out.append(nb if nb >= 2 else 1)
        done += nb if nb >= 2 else 1
    return out


@pytest.mark.parametrize("b", [4, 24])
@pytest.mark.parametrize("n_chunks,pause", [(8, None), (64, 10), (65, 30)])
def test_torch_scan_batch_boundaries(b, n_chunks, pause):
    chunk = 16
    src, sink = _BatchSource(n_chunks * chunk), _BatchSink()
    g = Graph()
    g.chain(src, blocks.MultiplyConst(2.0), sink)
    _run(g, chunk_size=chunk, scan_chunks=b, max_chunks=pause)
    jsrc = _JBatchSource(n_chunks * chunk)
    jg = JGraph()
    jg.chain(jsrc, jblocks.MultiplyConst(2.0), jblocks.NullSink())
    jg.run_stream(chunk_size=chunk, scan_chunks=b, max_chunks=pause)
    want = _expected_nb(n_chunks, b, pause)
    assert [c[2] for c in src.calls] == want
    assert src.calls == jsrc.calls
    # the hooks: one call a batch, one a lone chunk
    assert sink.calls == want
    done = sum(want)
    assert np.array_equal(np.concatenate(sink.chunks), 2 * src.data[:done * chunk])


# ---- the CUDA-graph path of the runner, the capture stood in for


class _Record:
    counts = {"fm_chain": 0}


class _Replayed:
    """A capture's stand-in: each replay runs the recorded function, whose
    Python values (frozen at the capture) are the replays' too."""

    def __init__(self, fn):
        self.fn, self.record = fn, _Record()

    def replay(self):
        return self.fn()


@pytest.fixture
def stand_in_capture(monkeypatch):
    made = []

    def capture(device, fn):
        made.append(_Replayed(fn))
        return made[-1]

    monkeypatch.setattr(graph_mod, "_can_capture", lambda device: True)
    monkeypatch.setattr(graph_mod, "_warm_up", lambda device, fn: (fn(), _Record()))
    monkeypatch.setattr(graph_mod, "_capture", capture)
    return made


def _fm_graph(data, taps, sink, tail=None):
    g = Graph()
    chain = [blocks.VectorSource(data), blocks.FirFilter(taps, deci=4),
             blocks.QuadratureDemod(1.0), blocks.MultiplyConst(0.5)]
    if tail is not None:
        chain.append(tail)
    g.chain(*chain, sink)
    return g


def test_torch_scan_captured_units_equal_per_chunk(stand_in_capture, tmp_path):
    # 11 chunks of 4096 and a ragged tail: chunk 1 alone, replays of 4, 4
    # and 2 chunks, the tail alone; bit-equal to the per-chunk run, the
    # FirFilter's counter advanced by the replays, a pause and a resume
    rng = np.random.RandomState(5)
    data = (rng.randn(4096 * 11 + 1000) + 1j * rng.randn(4096 * 11 + 1000)
            ).astype(np.complex64)
    taps = (rng.randn(49) / 7).astype(np.float32)
    ref = blocks.VectorSink()
    _run(_fm_graph(data, taps, ref), chunk_size=4096)
    sink = blocks.VectorSink()
    g = _fm_graph(data, taps, sink)
    _run(g, chunk_size=4096, scan_chunks=4)
    assert np.array_equal(sink.data(), ref.data())
    assert [(e["unit"], e["nb"], e["replays"]) for e in g.capture_log] == [
        ("FirFilter+QuadratureDemod+MultiplyConst", 4, 2),
        ("FirFilter+QuadratureDemod+MultiplyConst", 2, 1)]
    # paused at 7 chunks with a checkpoint, resumed: the states are copied
    # into the capture's static tensors, the counter carried on
    ck = str(tmp_path / "c.ckpt")
    s1, s2 = blocks.VectorSink(), blocks.VectorSink()
    g1 = _fm_graph(data, taps, s1)
    _run(g1, chunk_size=4096, scan_chunks=4, max_chunks=7, checkpoint_path=ck,
         checkpoint_every=3)
    with open(ck, "rb") as f:
        st = pickle.load(f)
    # saved when the batches crossed 3 and 6: the last at 7 chunks, where
    # the filter has given (7 * 4096 - 49) // 4 + 1 outputs
    assert st["offset"] == 7 * 4096 and st["states"][1]["out_off"] == 7 * 1024 - 12
    g2 = _fm_graph(data, taps, s2)
    _run(g2, chunk_size=4096, scan_chunks=4, resume_from=ck)
    assert np.array_equal(np.concatenate([s1.data(), s2.data()]), ref.data())


def test_torch_scan_capture_decided_by_flags_and_shapes(stand_in_capture):
    x = np.random.RandomState(2).randn(4096).astype(np.float32)
    # a member that declares itself not capturable: no capture at all
    g = Graph()
    g.chain(blocks.VectorSource(x), blocks.AddConst(1.0),
            blocks.SinglePoleIirFilter(0.1), blocks.VectorSink())
    _run(g, chunk_size=256, scan_chunks=4)
    assert g.capture_log == [] and stand_in_capture == []
    # a state whose shape changes every chunk (a FIR whose decimation
    # does not divide the chunk): decided at the warm-up, chunk by chunk
    ref, s = blocks.VectorSink(), blocks.VectorSink()
    for sink, scan in ((ref, None), (s, 4)):
        g = Graph()
        g.chain(blocks.VectorSource(x),
                blocks.FirFilter(np.ones(5, np.float32) / 5, deci=3),
                blocks.MultiplyConst(2.0), sink)
        _run(g, chunk_size=256, scan_chunks=scan)
    assert np.array_equal(s.data(), ref.data()) and g.capture_log == []
    # capturable units alone, each over three batches: equal to per chunk
    for block in (blocks.MultiplyConst(3.0), blocks.FftStream(64),
                  blocks.Hilbert(17), blocks.FftFilterFloat(np.ones(9) / 9)):
        outs = []
        for scan in (None, 4):
            sink = blocks.VectorSink()
            g = Graph()
            g.chain(blocks.VectorSource(x), type(block)(*_args(block)), sink)
            _run(g, chunk_size=256, scan_chunks=scan)
            outs.append(sink.data())
        assert np.array_equal(outs[0], outs[1]), block.name()
        assert [e["replays"] for e in g.capture_log] == [3, 1], block.name()


def _args(block):
    return {"MultiplyConst": (3.0,), "FftStream": (64,), "Hilbert": (17,),
            "FftFilterFloat": (np.ones(9) / 9,)}[block.name()]


# ---- every block class declares whether a CUDA graph may record it

CAPTURABLE = {
    "Add", "AddConst", "BinarySlicer", "ComplexToFloat", "ComplexToMag2",
    "ComplexToReal", "FastFM", "FftFilter", "FftFilterFloat", "FftStream",
    "FirFilter", "FloatToComplex", "Hilbert", "MultiplyConst",
    "QuadratureDemod", "RtlSdrDecode", "RtlSdrEncode", "Tee", "Vco", "Xor",
    "XorConst",
}
NOT_CAPTURABLE = {
    "AuDecode", "AuEncode", "AudioSink", "BurstTagger", "Canary",
    "CmaEqualizer", "ConstantSource",
    "CorrelateAccessCode", "CorrelateAccessCodeTag", "DebugFilter", "DebugSink",
    "Delay", "Descrambler", "DeviceFoldSink", "FcsAdder", "Fft", "FileSink",
    "FileSource", "Hasher", "HdlcDeframer", "HdlcFramer", "Head",
    "Il2pDeframer", "Inspect", "IqBalance", "KissDecode", "KissEncode",
    "KissFrame", "Map", "Midpointer", "MorseEncode", "NoiseSource",
    "NrziDecode", "NrziEncode", "NullSink", "PackedIqRingSource", "PduFileSink",
    "PduMap", "PduToStream", "PduVectorSink", "PduWriter", "PipewireSink",
    "PipewireSource", "RationalResampler", "ReaderSource", "RtlSdrSource",
    "Scrambler", "SdrSink", "SdrSource", "SignalSourceComplex",
    "SignalSourceFloat", "SinglePoleIirFilter", "Skip", "SoapySdrSink",
    "StreamToPdu", "Strobe", "SymbolSync", "TcpSource", "ToText", "VectorSink",
    "VectorSource", "Wpcr", "WriterSink", "ZeroCrossing",
}


def _block_classes():
    found = {}
    for mod in (blocks, hw):
        for name in dir(mod):
            obj = getattr(mod, name)
            if inspect.isclass(obj) and issubclass(obj, Block) and obj not in (
                    Block, SourceBlock):
                found[obj.__name__] = obj
    return found


def test_torch_every_block_class_declares_graph_capturable():
    classes = _block_classes()
    assert set(classes) == CAPTURABLE | NOT_CAPTURABLE
    for name, cls in classes.items():
        assert "graph_capturable" in vars(cls), f"{name} does not declare it"
        assert cls.graph_capturable is (name in CAPTURABLE), name
    # per instance where the parameters decide
    assert not blocks.FirFilter([1.0, 1.0], translate=(48e3, 1e3)).graph_capturable
    assert not blocks.FftFilter(np.ones(8) * 1j).graph_capturable
    assert not blocks.FftFilterFloat(np.ones(5000)).graph_capturable
