"""The port's I/O blocks (``blocks/io_blocks.py``) against the JAX
package's, on the same seeded inputs, on the CPU.

``CmaEqualizer`` mirrors tests/test_graph.py:268-300: the window slides
(mu = 0 is an exact passthrough), it converges on a gain error, and its
streamed output is, bit for bit, the calls it makes (one a chunk, the
last ntaps - 1 samples and the taps carried) over chunk sizes from 1 to
2048, and within 1e-5 of max|y| of its offline output: kernel F's blocks
of windows count from each call's start, so a call's seams round in
another order (tests/test_torch_recurrences.py).  Against the JAX block
it is held within 1e-5 of max|y| (the recurrence in another rounding
order), and a JAX state resumes in the port.
The byte blocks (the .au and rtl-sdr codecs, the reader, writer and TCP
source, the strobe) give the JAX blocks' bytes and samples exactly.
Every socket and queue wait here has its own timeout.
"""

import io
import os
import socket
import threading

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu_torch import blocks
from rustradio_tpu_torch.convert import state_from_jax
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.io import au
from rustradio_tpu_torch.ops import kernels

CPU = "cpu"
CMA_TOL = 1e-5


def _qpsk(rng, n, gain=1.0):
    return (gain * np.exp(2j * np.pi * rng.randint(0, 4, n) / 4)).astype(np.complex64)


def _run(g, sink, chunk=None):
    if chunk is None:
        g.run(device=CPU)
    else:
        g.run_stream(chunk_size=chunk, device=CPU)
    return np.asarray(sink.data())


def _chunk_calls(x, ntaps, mu, chunk, taps=None, carry=None):
    """The CMA recurrence over ``x`` fed ``chunk`` samples a call, as a
    streamed ``CmaEqualizer`` feeds it: each call on the carried samples
    and the chunk, from the carried taps (kernels.cma_scan_plain)."""
    if taps is None:
        taps = torch.eye(1, ntaps, dtype=torch.complex64)[0]
    buf = torch.zeros(0, dtype=torch.complex64) if carry is None else carry
    out = []
    for lo in range(0, len(x), chunk):
        buf = torch.cat([buf, torch.from_numpy(x[lo : lo + chunk])])
        if buf.shape[0] >= ntaps:
            y, taps = kernels.cma_scan_plain(buf, taps, 1.0, mu)
            out.append(y.numpy())
            buf = buf[buf.shape[0] - (ntaps - 1):]
    return np.concatenate(out), taps


def _near(a, b):
    return np.abs(a - b).max() <= CMA_TOL * np.abs(b).max()


def _jrun(g, sink, chunk=None):
    if chunk is None:
        g.run()
    else:
        g.run_stream(chunk_size=chunk)
    return np.asarray(sink.data())


def _chain(pkg, graph, *blks):
    g, s = graph(), pkg.VectorSink()
    g.chain(*blks, s)
    return g, s


# ---- CmaEqualizer (tests/test_graph.py:268-300)

def test_torch_cma_equalizer_window_slides():
    # reference src/cma.rs test: step_size 0, identity taps => passthrough
    x = np.asarray([1, 2, 3], np.complex64)
    for pkg, graph, run in ((blocks, Graph, _run), (jblocks, JGraph, _jrun)):
        g, s = _chain(pkg, graph, pkg.VectorSource(x), pkg.CmaEqualizer(2, 1.0, 0.0))
        assert np.array_equal(run(g, s), x[:2])


def test_torch_cma_equalizer_converges_on_gain_error():
    # QPSK scaled by 0.5: CMA must restore unit modulus (tap0 -> 2.0)
    sym = _qpsk(np.random.RandomState(5), 6000, 0.5)
    outs = []
    for pkg, graph, run in ((blocks, Graph, _run), (jblocks, JGraph, _jrun)):
        g, s = _chain(pkg, graph, pkg.VectorSource(sym), pkg.CmaEqualizer(3, 1.0, 1e-2))
        out = run(g, s)
        assert np.abs(np.abs(out[-200:]) - 1).mean() < 1e-3
        outs.append(out)
    assert np.abs(outs[0] - outs[1]).max() <= CMA_TOL * np.abs(outs[1]).max()


@pytest.mark.parametrize("chunk", [1, 2, 3, 15, 16, 17, 173, 1024, 2048])
def test_torch_cma_equalizer_streams_as_offline(chunk):
    rng = np.random.RandomState(6)
    x = (rng.randn(2500) + 1j * rng.randn(2500)).astype(np.complex64) * 0.5
    n = 600 if chunk == 1 else 2500  # one sample a chunk: a shorter stream

    def build(pkg, graph):
        return _chain(pkg, graph, pkg.VectorSource(x[:n]), pkg.CmaEqualizer(16, 1.0, 1e-3))

    offline = _run(*build(blocks, Graph))
    assert len(offline) == n - 15
    streamed = _run(*build(blocks, Graph), chunk=chunk)
    assert np.array_equal(streamed, _chunk_calls(x[:n], 16, 1e-3, chunk)[0])
    assert _near(streamed, offline)
    if chunk in (173, 2048):  # the JAX block streamed the same way
        want = _jrun(*build(jblocks, JGraph), chunk=chunk)
        assert np.abs(offline - want).max() <= CMA_TOL * np.abs(want).max()


def test_torch_cma_equalizer_short_chunks_carry_the_window():
    blk = blocks.CmaEqualizer(5, 1.0, 1e-2)
    x = _qpsk(np.random.RandomState(1), 40, 0.7)
    state, out = blk.init_state(), []
    for lo, hi in ((0, 2), (2, 3), (3, 9), (9, 40)):
        state, y = blk.apply_chunk(state, torch.from_numpy(x[lo:hi]))
        out.append(y.numpy())
    assert [len(o) for o in out] == [0, 0, 5, 31]  # no window before 5 samples
    taps = torch.eye(1, 5, dtype=torch.complex64)[0]
    y1, taps = kernels.cma_scan_plain(torch.from_numpy(x[:9]), taps, 1.0, 1e-2)
    y2, taps = kernels.cma_scan_plain(torch.from_numpy(x[5:]), taps, 1.0, 1e-2)
    assert np.array_equal(out[2], y1.numpy()) and np.array_equal(out[3], y2.numpy())
    assert torch.equal(state["taps"], taps)
    assert _near(np.concatenate(out), blk.apply(torch.from_numpy(x)).numpy())
    assert state["carry"].shape == (4,) and state["taps"].shape == (5,)


def test_torch_cma_equalizer_resumes_a_jax_state():
    rng = np.random.RandomState(9)
    x = (0.5 * _qpsk(rng, 5000) + 0.01 * rng.randn(5000)).astype(np.complex64)
    cut = 3001
    jb = jblocks.CmaEqualizer(8, 1.0, 1e-2)
    jstate, jhead = jb.apply_chunk(jb.init_state(), x[:cut])
    jstate2, jtail = jb.apply_chunk(jstate, x[cut:])
    state = state_from_jax({k: np.asarray(v) for k, v in jstate.items()}, device=CPU)
    assert state["carry"].shape == (7,) and state["taps"].dtype == torch.complex64
    blk = blocks.CmaEqualizer(8, 1.0, 1e-2)
    state2, tail = blk.apply_chunk(state, torch.from_numpy(x[cut:]))
    assert len(tail) == len(jtail) == 5000 - cut
    scale = np.abs(np.asarray(jtail)).max()
    assert np.abs(tail.numpy() - np.asarray(jtail)).max() <= CMA_TOL * scale
    assert (np.abs(state2["taps"].numpy() - np.asarray(jstate2["taps"])).max()
            <= CMA_TOL * np.abs(np.asarray(jstate2["taps"])).max())
    # and the port carries its own state the same way: the tail is the
    # call on the carried samples and taps, head + tail the offline run
    # within CMA_TOL
    own, head = blk.apply_chunk(blk.init_state(), torch.from_numpy(x[:cut]))
    _, tail = blk.apply_chunk(own, torch.from_numpy(x[cut:]))
    want, _ = kernels.cma_scan_plain(torch.cat([own["carry"], torch.from_numpy(x[cut:])]),
                                     own["taps"], 1.0, 1e-2)
    assert torch.equal(tail, want)
    whole = blk.apply(torch.from_numpy(x))
    assert _near(np.concatenate([head.numpy(), tail.numpy()]), whole.numpy())


# ---- the rtl-sdr codec (tests/test_graph.py:255-265)

def test_torch_rtlsdr_roundtrip_and_bytes_match_jax():
    rng = np.random.RandomState(2)
    raw = rng.randint(0, 256, 4000).astype(np.uint8)
    iq = raw.astype(np.float32) - 127.0
    x = ((iq[0::2] + 1j * iq[1::2]) * 0.008).astype(np.complex64)
    outs = {}
    for name, pkg, graph, run in (("port", blocks, Graph, _run),
                                  ("jax", jblocks, JGraph, _jrun)):
        g, s = _chain(pkg, graph, pkg.VectorSource(x), pkg.RtlSdrEncode(),
                      pkg.RtlSdrDecode())
        outs[name] = run(g, s)
        np.testing.assert_allclose(outs[name], x, atol=1e-5)
        g, s = _chain(pkg, graph, pkg.VectorSource(raw), pkg.RtlSdrDecode())
        outs[name + " decode"] = run(g, s)
        g, s = _chain(pkg, graph, pkg.VectorSource(3 * x), pkg.RtlSdrEncode())
        outs[name + " encode"] = run(g, s)  # clips past +-1.016
    for k in ("", " decode", " encode"):
        assert np.array_equal(outs["port" + k], outs["jax" + k]), k
    assert np.array_equal(outs["port decode"], x)


def test_torch_rtlsdr_blocks_stream_in_chunks():
    raw = np.random.RandomState(4).randint(0, 256, 6000).astype(np.uint8)
    g, s = _chain(blocks, Graph, blocks.VectorSource(raw), blocks.RtlSdrDecode(),
                  blocks.RtlSdrEncode())
    assert np.array_equal(_run(g, s, chunk=1000), raw)


# ---- the .au codec

@pytest.mark.parametrize("chunk", [None, 5, 23, 1000])
def test_torch_au_codec_matches_jax(chunk):
    rng = np.random.RandomState(3)
    pcm = np.clip(0.3 * rng.randn(3001), -1.2, 1.2).astype(np.float32)
    outs = {}
    for name, pkg, graph, run in (("port", blocks, Graph, _run),
                                  ("jax", jblocks, JGraph, _jrun)):
        g, s = _chain(pkg, graph, pkg.VectorSource(pcm), pkg.AuEncode(8000))
        outs[name + " enc"] = run(g, s, chunk).astype(np.uint8)
        g, s = _chain(pkg, graph, pkg.VectorSource(outs[name + " enc"]),
                      pkg.AuDecode(8000))
        outs[name + " dec"] = run(g, s, chunk)
    assert np.array_equal(outs["port enc"], outs["jax enc"])
    assert outs["port enc"].tobytes() == au.au_encode(pcm, 8000)
    assert np.array_equal(outs["port dec"], outs["jax dec"])
    assert np.array_equal(outs["port dec"], au.au_decode(au.au_encode(pcm, 8000), 8000)[0])


def test_torch_au_decode_rejects_bad_headers():
    bad = np.frombuffer(b"\0" * 40, np.uint8)
    for blk in (blocks.AuDecode(8000),):
        with pytest.raises(ValueError, match="magic"):
            blk.apply_chunk(blk.init_state(), torch.from_numpy(bad.copy()))
    wrong_rate = np.frombuffer(au.au_encode(np.zeros(4, np.float32), 16000), np.uint8)
    blk = blocks.AuDecode(8000)
    with pytest.raises(ValueError, match="bitrate"):
        blk.apply_chunk(blk.init_state(), torch.from_numpy(wrong_rate.copy()))
    with pytest.raises(ValueError, match="mono"):
        blocks.AuEncode(8000, channels=2)


# ---- Strobe, ReaderSource, WriterSink, TcpSource
# (tests/test_misc_blocks.py, tests/test_streaming_sources.py)

def test_torch_strobe_emits_n_copies():
    msg = np.frombuffer(b"beacon", np.uint8)
    for s in (blocks.Strobe(msg, count=3), jblocks.Strobe(msg, count=3)):
        out = s.emit(0, 3)
        assert len(out) == 3 and s.total_len() == 3
        assert all(bytes(p.data) == b"beacon" for p in out)


def test_torch_reader_source_streams_and_ends_at_eof():
    payload = bytes(range(256)) * 400  # 102400 bytes
    src = blocks.ReaderSource(io.BytesIO(payload), read_size=1024, timeout=10.0)
    g = Graph()
    sink = g.add(blocks.VectorSink(), g.add(src))
    # nominal bound far larger than the data: EOF must end the stream
    g.run_stream(chunk_size=4096, max_chunks=1000, device=CPU)
    assert bytes(sink.block.data().astype(np.uint8)) == payload
    assert src.exhausted()
    # offline: drained to EOF, as the JAX block
    got = blocks.ReaderSource(io.BytesIO(payload), timeout=10.0).apply(CPU)
    want = np.asarray(jblocks.ReaderSource(io.BytesIO(payload)).apply())
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_torch_reader_source_fails_on_a_stalled_or_broken_reader():
    class Broken(io.RawIOBase):
        def read(self, n=-1):
            raise OSError("device gone")

    src = blocks.ReaderSource(Broken(), timeout=10.0)
    with pytest.raises(OSError, match="device gone"):
        src.emit(0, 16, CPU)
    r, w = os.pipe()  # a reader that never delivers
    try:
        src = blocks.ReaderSource(os.fdopen(r, "rb", buffering=0), timeout=0.2)
        with pytest.raises(TimeoutError):
            src.emit(0, 16, CPU)
    finally:
        os.close(w)


def test_torch_writer_sink_writes_the_jax_bytes():
    data = np.arange(1000, dtype=np.float32)
    outs = []
    for pkg, graph, run in ((blocks, Graph, _run), (jblocks, JGraph, _jrun)):
        buf = io.BytesIO()
        g = graph()
        g.chain(pkg.VectorSource(data), pkg.WriterSink(buf))
        if pkg is blocks:
            g.run_stream(chunk_size=300, device=CPU)
        else:
            g.run_stream(chunk_size=300)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == data.tobytes()


def _serve_once(payload):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        with conn:
            conn.sendall(payload)
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], t


def test_torch_tcp_source_bounded_buffer():
    payload = np.random.RandomState(8).randint(0, 256, 65536).astype(np.uint8).tobytes()
    got = []
    for pkg in (blocks, jblocks):
        port, t = _serve_once(payload)
        src = (blocks.TcpSource("127.0.0.1", port, timeout=10.0) if pkg is blocks
               else jblocks.TcpSource("127.0.0.1", port))
        g = Graph() if pkg is blocks else JGraph()
        sink = g.add(pkg.VectorSink(), g.add(src))
        if pkg is blocks:
            g.run_stream(chunk_size=4096, max_chunks=100, device=CPU)
        else:
            g.run_stream(chunk_size=4096, max_chunks=100)
        t.join(timeout=10)
        assert not t.is_alive()
        got.append(bytes(np.asarray(sink.block.data()).astype(np.uint8)))
        # consumed bytes are dropped, not accumulated
        assert len(src._buf) == 0
    assert got[0] == got[1] == payload


def test_torch_tcp_source_times_out_on_a_silent_peer():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        src = blocks.TcpSource("127.0.0.1", srv.getsockname()[1], timeout=0.2)
        with pytest.raises(TimeoutError):
            src.emit(0, 16, CPU)
        with pytest.raises(ValueError, match="sequential"):
            src._base = 10
            src.emit(0, 16, CPU)
    finally:
        srv.close()
