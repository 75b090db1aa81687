"""The signal generators, the FFT ops, the spectrogram and the utility
blocks of the port against the JAX package, on the same seeded numpy
inputs: ``ops.signal_source_c`` / ``_f`` (1e-6 absolute: the same f32
phases, sin and cos in f32 by two libraries), ``NoiseSource`` (bit-equal),
``fft_pdu`` / ``fft_stream`` / ``spectrogram`` (stated per test), the
sources, sinks, elementwise and packet blocks of this slice in graphs of
both packages (offline and streamed), and ``render_ascii`` (equal text).
The port runs on the CPU (``device="cpu"``); a numpy input without
``device=`` raises.
"""

import hashlib

import numpy as np
import pytest
import torch
# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process, ~2 s once: imported with this module, so that
# each test's time is its own.
import torch._dynamo  # noqa: F401

from rustradio_tpu import blocks as jblocks
from rustradio_tpu import ops as jops
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.streams import Pdu as JPdu
from rustradio_tpu.utils import waterfall as jwaterfall
from rustradio_tpu_torch import blocks, ops
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.streams import Pdu
from rustradio_tpu_torch.utils import waterfall

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("freq,offset", [(1000.0, 0), (-3300.0, 12345),
                                         (11_999.0, 1 << 31)])
def test_torch_signal_sources_equal_jax(freq, offset):
    got = ops.signal_source_c(5000, 48_000.0, freq, 0.7, offset, device=CPU)
    want = np.asarray(jops.signal_source_c(5000, 48_000.0, freq, 0.7, offset))
    assert got.dtype == torch.complex64 and got.shape == (5000,)
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)
    got = ops.signal_source_f(5000, 48_000.0, freq, 0.7, offset, device=CPU)
    want = np.asarray(jops.signal_source_f(5000, 48_000.0, freq, 0.7, offset))
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)


def test_torch_signal_phases_are_the_jax_host_phases():
    # the float64 ramp mod 2*pi, to f32: the JAX package's host numbers
    from rustradio_tpu.ops.signal import _phases as jphases
    from rustradio_tpu_torch.ops.signal import _phases

    for freq, off in ((1000.0, 0), (-3300.0, 10**9)):
        got = _phases(4096, 48_000.0, freq, off, CPU)
        assert np.array_equal(_np(got), np.asarray(jphases(4096, 48_000.0, freq, off)))


def test_torch_generators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ops.signal_source_c(16, 48_000.0, 1000.0)
    with pytest.raises(ValueError, match="device="):
        ops.fft_pdu(np.ones(8, np.complex64))


def _graph_out(mod, graph_cls, src, n=None, chunk=None, block=None):
    g, sink = graph_cls(), mod.VectorSink()
    chain = [src] + ([block] if block is not None else []) + [sink]
    g.chain(*chain)
    if graph_cls is Graph:
        if chunk:
            g.run_stream(chunk_size=chunk, device=CPU, max_chunks=n)
        else:
            g.run(device=CPU)
    else:
        if chunk:
            g.run_stream(chunk_size=chunk, max_chunks=n)
        else:
            g.run()
    return np.asarray(sink.data())


_SOURCES = {
    "complex": lambda m: m.SignalSourceComplex(48_000.0, 1234.0, 0.5, n=3000),
    "float": lambda m: m.SignalSourceFloat(48_000.0, -700.0, 0.9, n=3000),
    "constant": lambda m: m.ConstantSource(0.25, n=3000),
}


@pytest.mark.parametrize("kind", sorted(_SOURCES))
def test_torch_generator_blocks_equal_jax(kind):
    # bounded generators offline and streamed
    make = _SOURCES[kind]
    for chunk in (None, 700):
        got = _graph_out(blocks, Graph, make(blocks), chunk=chunk)
        want = _graph_out(jblocks, JGraph, make(jblocks), chunk=chunk)
        assert got.dtype == want.dtype and got.shape == want.shape == (3000,)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cplx", [False, True])
def test_torch_noise_source_is_the_jax_stream(cplx):
    # bit for bit, offline and streamed
    for chunk in (None, 500):
        got = _graph_out(blocks, Graph, blocks.NoiseSource(0.3, 7, 2000, cplx),
                         chunk=chunk)
        want = _graph_out(jblocks, JGraph,
                          jblocks.NoiseSource(0.3, 7, 2000, cplx), chunk=chunk)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_torch_file_and_constant_sources_equal_jax(tmp_path):
    # an unbounded constant needs max_chunks
    got = _graph_out(blocks, Graph, blocks.ConstantSource(3, None), n=3, chunk=10)
    assert np.array_equal(got, np.full(30, 3, np.int32))
    # FileSource: seeks per window, repeats
    path = str(tmp_path / "x.c32")
    data = (np.arange(1000) * (1 + 2j)).astype(np.complex64)
    data.tofile(path)
    for chunk in (None, 333):
        got = _graph_out(blocks, Graph, blocks.FileSource(path, "c32", repeat=2),
                         chunk=chunk)
        want = _graph_out(jblocks, JGraph, jblocks.FileSource(path, "c32", repeat=2),
                          chunk=chunk)
        assert np.array_equal(got, want) and np.array_equal(got, np.tile(data, 2))


def test_torch_fft_ops_equal_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(1000) + 1j * rng.randn(1000)).astype(np.complex64)
    w = np.hanning(1000).astype(np.float32)
    for window, shift in ((None, False), (w, True)):
        got = ops.fft_pdu(torch.from_numpy(x), window, shift)
        want = np.asarray(jops.fft_pdu(x, window, shift))
        # two f32 FFT libraries on 1000 points: 1e-4 of the largest bin
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * np.abs(want).max(),
                                   rtol=0)
    got, nf, left = ops.fft_stream(x, 128, device=CPU)
    want, jnf, jleft = jops.fft_stream(x, 128)
    assert nf == jnf == 7 and np.array_equal(_np(left), np.asarray(jleft))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5 * 128, rtol=0)
    with pytest.raises(ValueError, match="nonzero"):
        ops.fft_stream(x, 0, device=CPU)


@pytest.mark.parametrize("hop", [None, 300])
def test_torch_spectrogram_equals_jax(hop):
    rng = np.random.RandomState(5)
    t = np.arange(20_000)
    x = (np.exp(2j * np.pi * 0.1 * t) + 0.01 * (rng.randn(20_000)
         + 1j * rng.randn(20_000))).astype(np.complex64)
    got = _np(waterfall.spectrogram(x, 512, hop, device=CPU))
    want = np.asarray(jwaterfall.spectrogram(x, 512, hop))
    assert got.shape == want.shape
    # dB of f32 powers: 1e-3 dB where a bin holds more than 1e-6 of the
    # peak's power; the FFTs' rounding noise floor below that
    strong = want > want.max() - 60
    np.testing.assert_allclose(got[strong], want[strong], atol=1e-3, rtol=0)
    assert np.array_equal(got.argmax(1), want.argmax(1))
    # an input shorter than a frame: no frames
    assert waterfall.spectrogram(x[:100], 512, device=CPU).shape == (0, 512)
    # the renderer is the JAX package's
    assert waterfall.render_ascii(got, 60, 12) == jwaterfall.render_ascii(want, 60, 12)
    assert waterfall.render_ascii(np.zeros((0, 4))) == "(no data)"


def test_torch_elementwise_blocks_equal_jax():
    rng = np.random.RandomState(6)
    a = rng.randint(0, 256, 3000).astype(np.uint8)
    b = rng.randint(0, 256, 3000).astype(np.uint8)
    z = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    seen, jseen = [], []

    def two_in(mod, graph_cls, blk, x, y):
        g = graph_cls()
        s = mod.VectorSink()
        n = g.add(blk, g.add(mod.VectorSource(x)), g.add(mod.VectorSource(y)))
        g.add(s, n)
        return g, s

    def run(g, chunk=None):
        if isinstance(g, Graph):
            (g.run_stream(chunk_size=chunk, device=CPU) if chunk else g.run(device=CPU))
        else:
            (g.run_stream(chunk_size=chunk) if chunk else g.run())

    for chunk in (None, 512):
        for name in ("Add", "Xor"):
            g, s = two_in(blocks, Graph, getattr(blocks, name)(), a, b)
            jg, js = two_in(jblocks, JGraph, getattr(jblocks, name)(), a, b)
            run(g, chunk)
            run(jg, chunk)
            assert np.array_equal(s.data(), np.asarray(js.data())), name
        for mk, x in ((lambda m: m.XorConst(0x5A), a),
                      (lambda m: m.Map(lambda v: v * 3, "Triple"), z),
                      (lambda m: m.ComplexToReal(), z),
                      (lambda m: m.Inspect(
                          (seen if m is blocks else jseen).append), z)):
            got = _graph_out(blocks, Graph, blocks.VectorSource(x), chunk=chunk,
                             block=mk(blocks))
            want = _graph_out(jblocks, JGraph, jblocks.VectorSource(x),
                              chunk=chunk, block=mk(jblocks))
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.array_equal(np.concatenate(seen), np.concatenate(jseen))
    assert isinstance(seen[0], np.ndarray)
    # two-output blocks: Tee (tags on both), ComplexToFloat
    for two, want in ((blocks.Tee(), (z, z)), (blocks.ComplexToFloat(), (z.real, z.imag))):
        g = Graph()
        n = g.add(two, g.add(blocks.VectorSource(z)))
        s0, s1 = g.add(blocks.VectorSink(), n[0]), g.add(blocks.VectorSink(), n[1])
        g.run_stream(chunk_size=700, device=CPU)
        assert np.array_equal(s0.block.data(), want[0])
        assert np.array_equal(s1.block.data(), want[1])
        assert [t.key for t in s0.block.tags()] == [t.key for t in s1.block.tags()]
    # PduMap: one PDU in, zero or more out
    m = blocks.PduMap(lambda p: None if len(p.data) < 2 else [p, p])
    jm = jblocks.PduMap(lambda p: None if len(p.data) < 2 else [p, p])
    pdus = [Pdu(np.arange(k)) for k in range(4)]
    assert [len(p.data) for p in m.apply(pdus)] == [
        len(p.data) for p in jm.apply([JPdu(np.arange(k)) for k in range(4)])]


def test_torch_sink_blocks_equal_jax(tmp_path, capsys):
    x = np.arange(50, dtype=np.float32)
    printed = {}
    for mod, graph_cls in ((blocks, Graph), (jblocks, JGraph)):
        tag = "port" if mod is blocks else "jax"
        g = graph_cls()
        g.chain(mod.VectorSource(x), mod.DebugFilter(3, "filter"), mod.DebugSink(2))
        g.run(device=CPU) if graph_cls is Graph else g.run()
        printed[tag] = capsys.readouterr().out
        g = graph_cls()
        g.chain(mod.VectorSource(x), mod.FileSink(str(tmp_path / f"{tag}.f32")))
        (g.run_stream(chunk_size=16, device=CPU) if graph_cls is Graph
         else g.run_stream(chunk_size=16))
        p = mod.PduFileSink(str(tmp_path / f"{tag}.pdu"))
        pdu_cls = Pdu if mod is blocks else JPdu
        p.apply([pdu_cls(np.arange(5, dtype=np.uint8)),
                 pdu_cls(np.arange(3, dtype=np.uint8))])
        p.finish()
    assert printed["port"] == printed["jax"]
    assert "filter: ... 47 more" in printed["port"]
    assert "debug: ... 48 more" in printed["port"]
    assert (tmp_path / "port.f32").read_bytes() == (tmp_path / "jax.f32").read_bytes()
    assert (tmp_path / "port.pdu").read_bytes() == (tmp_path / "jax.pdu").read_bytes()
    assert np.array_equal(np.fromfile(tmp_path / "port.f32", "<f4"), x)


def test_torch_packet_blocks_equal_jax(tmp_path):
    rng = np.random.RandomState(7)
    z = (rng.randn(5000) + 1j * rng.randn(5000)).astype(np.complex64)
    # FftStream: offline, and streamed with its leftover carried
    for chunk in (None, 700, 1024):
        got = _graph_out(blocks, Graph, blocks.VectorSource(z), chunk=chunk,
                         block=blocks.FftStream(256))
        want = _graph_out(jblocks, JGraph, jblocks.VectorSource(z), chunk=chunk,
                          block=jblocks.FftStream(256))
        assert got.shape == want.shape == (19 * 256,)
        np.testing.assert_allclose(got, want, atol=2e-5 * 256, rtol=0)
    # Fft on PDUs: a tensor PDU on its device, a numpy one with device=
    w = np.hamming(64).astype(np.float32)
    pdus = [Pdu(torch.from_numpy(z[:64])), Pdu(z[64:128])]
    got = blocks.Fft(64, w, True, device=CPU).apply(pdus)
    want = jblocks.Fft(64, w, True).apply([JPdu(z[:64]), JPdu(z[64:128])])
    for g, j in zip(got, want):
        np.testing.assert_allclose(_np(g.data), np.asarray(j.data), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="expected 64"):
        blocks.Fft(64).apply([Pdu(z[:10])])
    # MorseEncode and its bits
    for msg in ("CQ CQ DE N0CALL", "sos 73", "a"):
        assert np.array_equal(blocks.morse_encode_bits(msg),
                              jblocks.packets.morse_encode_bits(msg))
    got = blocks.MorseEncode().apply([Pdu("hi")])
    want = jblocks.MorseEncode().apply([JPdu("hi")])
    assert np.array_equal(got[0].data, want[0].data)
    # Hasher: one digest PDU at the end of the stream
    data = rng.randint(0, 256, 3000).astype(np.uint8)
    for chunk in (None, 1000):
        outs = []
        for mod, graph_cls in ((blocks, Graph), (jblocks, JGraph)):
            g, s = graph_cls(), mod.PduVectorSink()
            g.chain(mod.VectorSource(data), mod.Hasher(), s)
            if graph_cls is Graph:
                (g.run_stream(chunk_size=chunk, device=CPU) if chunk
                 else g.run(device=CPU))
            else:
                g.run_stream(chunk_size=chunk) if chunk else g.run()
            outs.append([bytes(np.asarray(p.data)) for p in s.pdus()])
        assert outs[0] == outs[1] == [hashlib.sha512(data.tobytes()).digest()]
    # ToText: one line per sample, the streams side by side
    t = blocks.ToText(2).apply(torch.arange(3), torch.arange(3) * 2)
    jt = jblocks.ToText(2).apply(np.arange(3), np.arange(3) * 2)
    assert bytes(_np(t)) == bytes(np.asarray(jt)) == b"0 0\n1 2\n2 4\n"
    # Canary: its lambda at the end of every run
    fired = []
    g = Graph()
    g.chain(blocks.VectorSource(np.ones(10, np.float32)),
            blocks.Canary(lambda: fired.append(1)), blocks.NullSink())
    g.run_stream(chunk_size=4, device=CPU)
    g.run(device=CPU)
    assert fired == [1, 1]
    # PduWriter: one file per PDU
    d = tmp_path / "pdus"
    blocks.PduWriter(str(d)).apply([Pdu(np.arange(4, dtype=np.uint8)),
                                    Pdu(torch.arange(3, dtype=torch.uint8))])
    files = sorted(d.iterdir())
    assert [f.read_bytes() for f in files] == [bytes([0, 1, 2, 3]), bytes([0, 1, 2])]
