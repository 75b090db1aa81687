"""The live-feed family of the port against the JAX package's: the native
ring and reader (``native.Ring``, ``native.FileReader``, the converters),
``runtime.DeviceFeeder``, the DATA_STREAM transports (``io/data_stream.py``,
``io/websocket.py``), the dashboard (``ui/``) and the apps
``rtl_data_stream`` and ``ui_server``, on the CPU.

The protocol tests mirror tests/test_formats.py:60-260,
tests/test_fuzz_parsers.py and tests/test_websocket.py and run, with the
same parameters, against both packages' modules (the port's are stdlib
copies), except where the port differs on purpose: its websocket server
rejects unmasked control frames, which the JAX package accepts
(``rustradio_tpu/io/websocket.py:131``; RFC 6455 section 5.1 asks for every
unmasked client frame to be rejected).  The feeder's chunks equal
``np.fromfile`` and the JAX feeder's arrays exactly.  ``downsample_u8``:
the JAX package filters by FFT on the CPU and the port by direct FIR, so
the bytes may differ by one LSB where a value sits at a rounding boundary
(at most 1% of the bytes here), and by no more.  Every socket, thread and
asyncio wait has a timeout of its own.
"""

import asyncio
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rustradio_tpu import native as jnative
from rustradio_tpu import runtime as jruntime
from rustradio_tpu.apps import rtl_data_stream as jrds
from rustradio_tpu.io import data_stream as jds
from rustradio_tpu.io import websocket as jws
from rustradio_tpu_torch import native, runtime
from rustradio_tpu_torch.apps import rtl_data_stream as rds
from rustradio_tpu_torch.io import data_stream as pds
from rustradio_tpu_torch.io import rawfile
from rustradio_tpu_torch.io import websocket as pws
from rustradio_tpu_torch.ui import SpectrumFeed, UiServer

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
DS = {"port": pds, "jax": jds}
WS = {"port": (pds, pws), "jax": (jds, jws)}


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


# ---- native ring, reader and converters (tests/test_native.py)

def test_torch_native_ring_basic_wrap_and_eof():
    r = native.Ring(4096)
    assert r.capacity >= 4096
    assert r.write(b"hello") == 5 and r.readable() == 5
    assert r.read(5) == b"hello" and r.readable() == 0
    chunk = bytes(range(256)) * 8  # 2048 bytes, past the capacity 5 times
    for _ in range(5 * r.capacity // len(chunk)):
        r.write(chunk)
        assert r.read(len(chunk)) == chunk
    r.write(b"tail")
    r.set_eof()
    assert not r.eof()  # data still pending
    assert r.read(10) == b"tail"  # short read at EOF
    assert r.eof() and r.error() == 0


def test_torch_native_ring_threaded_producer():
    r = native.Ring(1 << 16)
    data = np.random.RandomState(0).randint(0, 256, 1 << 20).astype(np.uint8)

    def produce():
        r.write(data)
        r.set_eof()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    out = bytearray()
    buf = np.empty(4096, np.uint8)
    while len(out) < data.nbytes:
        got = r.read_into(buf)
        out += buf[:got].tobytes()
    t.join(timeout=10)
    assert not t.is_alive() and bytes(out) == data.tobytes()


def test_torch_native_file_reader_repeats_and_reports(tmp_path):
    path = str(tmp_path / "x.bin")
    payload = np.arange(100000, dtype=np.uint32).tobytes()
    Path(path).write_bytes(payload)
    r = native.Ring(1 << 16)
    rd = native.FileReader(r, path, repeat=2)
    out = b""
    while True:
        chunk = r.read(8192)
        out += chunk
        if r.eof() and not chunk:
            break
    rd.stop()
    assert out == payload + payload
    r = native.Ring(4096)
    rd = native.FileReader(r, str(tmp_path / "missing"), repeat=1)
    deadline = time.time() + 10
    while not (r.error() or r.eof()) and time.time() < deadline:
        time.sleep(0.01)
    assert r.error() != 0
    rd.stop()


def test_torch_native_converters_match_jax():
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, 2001).astype(np.uint8)
    got = native.convert_i16be_f32(raw)
    assert np.array_equal(got, jnative.convert_i16be_f32(raw))
    np.testing.assert_allclose(got, raw[:2000].view(">i2").astype(np.float32) / 32767.0,
                               rtol=1e-6)
    for g, w in zip(native.convert_u8iq_planar(raw), jnative.convert_u8iq_planar(raw)):
        assert np.array_equal(g, w)
    i, q = native.convert_u8iq_planar(np.asarray([127, 127, 255, 0, 0, 255], np.uint8))
    np.testing.assert_allclose(i, [0.0, 1.024, -1.016], atol=1e-6)
    np.testing.assert_allclose(q, [0.0, -1.016, 1.024], atol=1e-6)
    x = (rng.randn(1000) + 1j * rng.randn(1000)).astype(np.complex64)
    i, q = native.deinterleave_c64(x)
    assert np.array_equal(i, x.real) and np.array_equal(q, x.imag)
    f = np.asarray([0.5, -0.5, 1.5, -1.5, 0.123], np.float32)
    assert np.array_equal(native.convert_f32_i16be(f), jnative.convert_f32_i16be(f))
    want = np.trunc(f * 32767.0).clip(-32768, 32767).astype(">i2")
    assert np.array_equal(np.frombuffer(native.convert_f32_i16be(f), ">i2"), want)


# ---- DeviceFeeder (rustradio_tpu/runtime.py)

_FORMATS = {
    "c32": lambda rng, n: (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64),
    "u8iq": lambda rng, n: rng.randint(0, 256, 2 * n).astype(np.uint8),
    "f32": lambda rng, n: rng.randn(n).astype(np.float32),
    "i16be": lambda rng, n: rng.randint(-32768, 32768, n).astype(">i2"),
}


def _planes(fmt, data):
    """The feeder's expected f32 planes of a whole file, from numpy."""
    if fmt == "c32":
        return [data.real, data.imag]
    if fmt == "u8iq":
        f = data.astype(np.float32) - np.float32(127.0)
        return [f[0::2] * np.float32(0.008), f[1::2] * np.float32(0.008)]
    if fmt == "i16be":
        return [data.astype(np.float32) * np.float32(1.0 / 32767.0)]
    return [data]


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_torch_device_feeder_chunks_equal_the_file_and_jax(tmp_path, fmt):
    rng = np.random.RandomState(len(fmt))
    n, chunk = 10_000, 3_000  # a partial last chunk each pass
    data = _FORMATS[fmt](rng, n)
    path = str(tmp_path / f"x.{fmt}")
    data.tofile(path)
    with runtime.DeviceFeeder(path, fmt, chunk, repeat=2, device=CPU) as feed:
        got = list(feed)
    jgot = list(jruntime.DeviceFeeder(path, fmt, chunk, repeat=2))
    sizes = [(c[0] if isinstance(c, tuple) else c).shape[0] for c in got]
    assert sizes == [3000, 3000, 3000, 3000, 3000, 3000, 2000]
    want = _planes(fmt, data)
    for k, plane in enumerate(want):
        if len(want) == 2:
            g = torch.cat([c[k] for c in got]).numpy()
            j = np.concatenate([np.asarray(c[k]) for c in jgot])
        else:
            g = torch.cat(got).numpy()
            j = np.concatenate([np.asarray(c) for c in jgot])
        assert np.array_equal(g, np.tile(plane, 2)), k
        assert np.array_equal(g, j), k


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_torch_device_feeder_without_the_native_library(tmp_path, monkeypatch, fmt):
    # the host fallback (Python file reads, numpy converters) gives the
    # native path's chunks
    data = _FORMATS[fmt](np.random.RandomState(3), 5_000)
    path = str(tmp_path / "x.bin")
    data.tofile(path)
    want = list(runtime.DeviceFeeder(path, fmt, 2_000, repeat=2, device=CPU))
    monkeypatch.setattr(native, "available", lambda: False)
    got = list(runtime.DeviceFeeder(path, fmt, 2_000, repeat=2, device=CPU))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert torch.equal(a, b)


def test_torch_device_feeder_stops_and_fails_cleanly(tmp_path):
    path = str(tmp_path / "x.f32")
    np.arange(1 << 16, dtype=np.float32).tofile(path)
    feed = runtime.DeviceFeeder(path, "f32", 1000, repeat=-1, device=CPU)
    it = iter(feed)
    first = [next(it) for _ in range(3)]
    t = threading.Thread(target=feed.close, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive()  # an endless feed stops on close()
    assert torch.equal(torch.cat(first), torch.arange(3000, dtype=torch.float32))
    with pytest.raises(OSError):
        list(runtime.DeviceFeeder(str(tmp_path / "missing"), "f32", device=CPU))
    with pytest.raises(ValueError, match="unknown format"):
        runtime.DeviceFeeder(path, "c64", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            runtime.DeviceFeeder(path, "f32")  # the card by default
    z = runtime.combine_iq(torch.ones(3), torch.full((3,), 2.0))
    assert z.dtype == torch.complex64 and torch.equal(z, torch.full((3,), 1 + 2j))


# ---- DATA_STREAM (tests/test_formats.py:60-260, tests/test_fuzz_parsers.py)

@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_data_stream_framing(pkg):
    ds = DS[pkg]
    assert ds.BytesReader().feed(ds.encode_version()) == [("version", 0)]
    with pytest.raises(ds.ProtocolError, match="first packet"):
        ds.BytesReader().feed(ds.encode_data("s", b"x"))
    wire = (ds.encode_version() + ds.encode_request_data("iq", 1024)
            + ds.encode_data("iq", b"hello world"))
    r, events = ds.BytesReader(), []
    for i in range(len(wire)):  # a byte at a time
        events += r.feed(wire[i : i + 1])
    assert events == [("version", 0), ("request_data", "iq", 1024),
                      ("data", "iq", b"hello world")]
    assert wire == (jds.encode_version() + jds.encode_request_data("iq", 1024)
                    + jds.encode_data("iq", b"hello world"))
    with pytest.raises(ds.ProtocolError, match="exceeds cap"):
        ds.BytesReader(max_packet=100).feed(ds.encode_data("s", b"x" * 200))
    with pytest.raises(ds.ProtocolError, match="zero-length"):
        ds.BytesReader().feed(struct.pack("<I", 0))
    assert ds.MAX_PACKET == 64 * 1024 * 1024


@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_data_stream_flow_control_and_reader(pkg):
    ds = DS[pkg]
    sent = []
    w = ds.SyncWriter(sent.append)
    assert w.send("iq", b"x" * 100) == 0  # no window granted
    w.grant("iq", 10)
    assert w.send("iq", b"x" * 100) == 10
    assert w.send("iq", b"x") == 0  # window exhausted
    w.grant("iq", 5)  # replaces window
    assert w.send("iq", b"abcdefgh") == 5
    sent = []
    r = ds.SyncReader(sent.append)
    r.request("iq", 4096)
    assert sent == [ds.encode_version(), ds.encode_request_data("iq", 4096)]
    r.feed(ds.encode_version() + ds.encode_data("iq", b"\x01\x02"))
    assert r.take("iq") == b"\x01\x02" and r.take("iq") == b""


@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_data_stream_parser_fuzz(pkg):
    ds = DS[pkg]
    rng = np.random.RandomState(0xFADE)
    outs = []
    for _ in range(50):
        parser = ds.BytesReader()
        data = rng.randint(0, 256, rng.randint(1, 400)).astype(np.uint8).tobytes()
        sizes = rng.randint(1, 64, 8)
        try:
            i = 0
            for s in sizes:
                outs.append(parser.feed(data[i : i + s]))
                i += s
            outs.append(parser.feed(data[i:]))
        except ds.ProtocolError as e:
            outs.append(str(e))  # the documented failure mode
    parser = ds.BytesReader()
    assert parser.feed(ds.encode_version()) == [("version", 0)]
    with pytest.raises(ds.ProtocolError):
        parser.feed(b"\xff\xff\xff\xff\x03")  # huge length prefix
    assert len(outs) >= 50


@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_async_reader_writer_roundtrip(pkg):
    ds = DS[pkg]

    async def go():
        srv_done = asyncio.Event()
        got = []

        async def handle(reader, writer):
            r, w = ds.AsyncReader(reader), ds.AsyncWriter(writer)
            await w.write_version()
            assert await r.read_version()
            got.append(await r.read_packet())
            await w.write_data("s", b"payload")
            await srv_done.wait()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        r, w = ds.AsyncReader(reader), ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("s", 1024)
        assert await r.read_packet() == ("data", "s", b"payload")
        srv_done.set()
        writer.close()
        server.close()
        await server.wait_closed()
        assert got == [("request_data", "s", 1024)]

    asyncio.run(asyncio.wait_for(go(), timeout=20))


async def _client(ds, port, window, expect, stream="rtl-sdr"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    r, w = ds.AsyncReader(reader), ds.AsyncWriter(writer)
    await w.write_version()
    assert await r.read_version()
    await w.write_request_data(stream, window)
    buf = b""
    while len(buf) < expect:
        pkt = await asyncio.wait_for(r.read_packet(), timeout=10)
        assert pkt[0] == "data"
        buf += pkt[2]
    writer.close()
    return buf


@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_data_stream_server_multi_client(pkg):
    # one slow client with a tiny window must not block a fast client
    ds = DS[pkg]
    payload = bytes(range(256)) * 64  # 16 KiB

    async def go():
        srv = ds.DataStreamServer(lambda pos, n: payload[pos : pos + n],
                                  packet_bytes=1024)
        _, port = await srv.serve()
        fast = _client(ds, port, len(payload), len(payload))
        slow = _client(ds, port, 512, 512)
        r_fast, r_slow = await asyncio.gather(fast, slow)
        await srv.close()
        return r_fast, r_slow

    r_fast, r_slow = asyncio.run(asyncio.wait_for(go(), timeout=20))
    assert r_fast == payload and r_slow == payload[:512]


@pytest.mark.parametrize("pkg", sorted(DS))
def test_torch_data_stream_server_window_replacement(pkg):
    # a second RequestData REPLACES the window (DATA_STREAM.md semantics)
    ds = DS[pkg]

    async def go():
        srv = ds.DataStreamServer(lambda pos, n: bytes([pos % 256]) * n,
                                  packet_bytes=128)
        _, port = await srv.serve()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        r, w = ds.AsyncReader(reader), ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("rtl-sdr", 128)
        assert len((await r.read_packet())[2]) == 128
        with pytest.raises(asyncio.TimeoutError):  # window spent: nothing more
            await asyncio.wait_for(r.read_packet(), timeout=0.3)
        await w.write_request_data("rtl-sdr", 256)
        total = 0
        while total < 256:
            total += len((await asyncio.wait_for(r.read_packet(), timeout=10))[2])
        assert total == 256
        writer.close()
        await srv.close()

    asyncio.run(asyncio.wait_for(go(), timeout=20))


# ---- websocket (tests/test_websocket.py)

@pytest.mark.parametrize("pkg", sorted(WS))
@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536])
@pytest.mark.parametrize("mask", [False, True])
def test_torch_ws_frame_roundtrip(pkg, n, mask):
    ws = WS[pkg][1]
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    payload = bytes(i % 256 for i in range(n))
    frame = ws.encode_frame(payload, ws.OP_BINARY, mask=mask)
    if not mask:
        assert frame == jws.encode_frame(payload, jws.OP_BINARY)

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await ws.read_frame(reader, require_masked=mask)

    assert asyncio.run(asyncio.wait_for(go(), timeout=10)) == (ws.OP_BINARY, payload)


@pytest.mark.parametrize("pkg", sorted(WS))
def test_torch_ws_data_stream_end_to_end_and_credit(pkg):
    ds, ws = WS[pkg]
    payload = bytes(range(256)) * 64

    async def go():
        srv = ds.WsDataStreamServer(lambda pos, n: payload[pos : pos + n],
                                    packet_bytes=1024)
        _, port = await srv.serve()
        reader, writer = await ws.ws_connect("127.0.0.1", port)
        r, w = ds.AsyncReader(reader), ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("rtl-sdr", 1024)
        first = (await asyncio.wait_for(r.read_packet(), timeout=10))[2]
        with pytest.raises(asyncio.TimeoutError):  # the window holds over ws
            await asyncio.wait_for(r.read_packet(), timeout=0.3)
        await w.write_request_data("rtl-sdr", len(payload) - 1024)
        buf = first
        while len(buf) < len(payload):
            pkt = await asyncio.wait_for(r.read_packet(), timeout=10)
            assert pkt[0] == "data" and pkt[1] == "rtl-sdr"
            buf += pkt[2]
        await writer.close_ws()
        writer.close()
        await srv.close()
        return buf

    assert asyncio.run(asyncio.wait_for(go(), timeout=20)) == payload


@pytest.mark.parametrize("pkg", sorted(WS))
def test_torch_ws_rejects_plain_http_and_oversize(pkg):
    ds, ws = WS[pkg]

    async def go():
        srv = ds.WsDataStreamServer(lambda p, n: b"", packet_bytes=128)
        _, port = await srv.serve()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        assert b"400" in await asyncio.wait_for(reader.read(64), timeout=10)
        writer.close()
        await srv.close()
        hdr = struct.pack("!BBQ", 0x80 | ws.OP_BINARY, 127, ws.MAX_FRAME + 1)
        big = asyncio.StreamReader()
        big.feed_data(hdr)
        with pytest.raises(ws.WsError):
            await ws.read_frame(big)

    asyncio.run(asyncio.wait_for(go(), timeout=20))


async def _close_code_after(ds, ws, frame):
    """Send one raw client frame to a ws DATA_STREAM server; the close code
    it answers with, or None if it answered the frame otherwise."""
    srv = ds.WsDataStreamServer(lambda p, n: b"\0" * n, packet_bytes=128)
    _, port = await srv.serve()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await ws.client_handshake(reader, writer, "127.0.0.1")
    writer.write(frame)
    await writer.drain()
    code = None
    try:
        while True:  # skip the server's version packet
            op, payload = await asyncio.wait_for(ws.read_frame(reader), timeout=2)
            if op == ws.OP_CLOSE:
                code = int.from_bytes(payload[:2], "big")
                break
            if op == ws.OP_PONG:
                break
    except asyncio.TimeoutError:
        pass
    writer.close()
    await srv.close()
    return code


@pytest.mark.parametrize("pkg", sorted(WS))
def test_torch_ws_server_rejects_unmasked_client_data_frame(pkg):
    ds, ws = WS[pkg]
    frame = ws.encode_frame(b"\1\0\0\0\0", ws.OP_BINARY, mask=False)
    code = asyncio.run(asyncio.wait_for(_close_code_after(ds, ws, frame), timeout=20))
    assert code == 1002


def test_torch_ws_server_rejects_unmasked_control_frames_unlike_jax():
    # RFC 6455 5.1: every client frame must be masked.  The port's server
    # closes 1002 on an unmasked ping; the JAX package's
    # (rustradio_tpu/io/websocket.py:131) answers it with a pong.
    def run(ds, ws):
        frame = ws.encode_frame(b"hi", ws.OP_PING, mask=False)
        return asyncio.run(asyncio.wait_for(_close_code_after(ds, ws, frame), timeout=20))

    assert run(pds, pws) == 1002
    assert run(jds, jws) is None  # the JAX side's acceptance, pinned

    async def masked_ping_is_answered():
        reader = asyncio.StreamReader()
        reader.feed_data(pws.encode_frame(b"hi", pws.OP_PING, mask=True))
        return await pws.read_frame(reader, require_masked=True)

    assert asyncio.run(asyncio.wait_for(masked_ping_is_answered(), timeout=10)) == (
        pws.OP_PING, b"hi")


# ---- the dashboard (tests/test_ui.py)

def _tone_chunks(fs=48_000.0, f=6_000.0):
    t = np.arange(int(fs)) / fs
    iq = (0.5 * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    return [iq[i : i + 12_000] for i in range(0, len(iq), 12_000)]


def test_torch_ui_server_endpoints():
    fs = 48_000.0
    feed = SpectrumFeed(iter(_tone_chunks()), samp_rate=fs, fft_size=256, fps=20.0,
                        realtime=False, stats_fn=lambda: "block stats here",
                        device=CPU)
    srv = UiServer(feed).start()
    try:
        feed.join(timeout=30)
        assert feed.done and feed.error is None
        page = _get(srv.address + "/").decode()
        assert "Waterfall" in page and "canvas" in page
        meta = json.loads(_get(srv.address + "/api/meta"))
        assert meta["fft_size"] == 256 and meta["samp_rate"] == fs
        fr = json.loads(_get(srv.address + "/api/frames?since=0"))
        assert fr["next"] > 0 and len(fr["rows"]) == fr["next"] - fr["start"]
        row = bytes.fromhex(fr["rows"][-1])
        assert len(row) == 256
        peak = int(np.argmax(np.frombuffer(row, np.uint8)))
        assert abs(peak - (128 + int(6_000.0 / fs * 256))) <= 1
        fr2 = json.loads(_get(srv.address + f"/api/frames?since={fr['next']}"))
        assert fr2["rows"] == [] and fr2["done"]
        assert json.loads(_get(srv.address + "/api/stats"))["text"] == "block stats here"
    finally:
        srv.stop()


def test_torch_ui_rows_equal_jax_rows():
    # the tone over a noise floor 40 dB down, so that every bin is well
    # above the f32 FFTs' rounding; the two FFTs agree within 0.01 dB
    from rustradio_tpu.ui import SpectrumFeed as JSpectrumFeed

    rng = np.random.RandomState(5)
    chunks = [(c + 0.005 * (rng.randn(len(c)) + 1j * rng.randn(len(c)))).astype(
        np.complex64) for c in _tone_chunks()]
    feeds = [SpectrumFeed(iter(chunks), 48_000.0, fft_size=256,
                          realtime=False, device=CPU),
             JSpectrumFeed(iter(chunks), 48_000.0, fft_size=256,
                           realtime=False)]
    for f in feeds:
        f.start()
        f.join(timeout=30)
        assert f.done
    (s0, n0, got), (s1, n1, want) = (f.frames_since(0) for f in feeds)
    assert (s0, n0) == (s1, n1) and n0 == 20  # 4 chunks of 5 rows
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-2, rtol=0)
    # frames_since from the middle, and a limit that truncates
    assert feeds[0].frames_since(15)[:2] == (15, 20)
    start, nxt, rows = feeds[0].frames_since(0, limit=7)
    assert (start, nxt, len(rows)) == (0, 7, 7)


def test_torch_ui_feed_needs_a_device_and_reports_failures():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SpectrumFeed(iter([]), 48_000.0)  # the card by default

    def broken():
        yield np.zeros(1000, np.complex64)
        raise OSError("source gone")

    feed = SpectrumFeed(broken(), 48_000.0, fft_size=256, realtime=False, device=CPU)
    feed.start()
    feed.join(timeout=30)
    assert feed.done and isinstance(feed.error, OSError)


def test_torch_ui_live_sdr_retune():
    from rustradio_tpu_torch.apps.ui_server import sdr_chunks
    from rustradio_tpu_torch.hw import SdrSource, SimDriver

    fs = 100_000.0
    drv = SimDriver(frequency=1e6, sample_rate=fs, gain=1.0,
                    tones=[(1e6 + 10_000.0, 1.0)], total_samples=2_000_000)
    src = SdrSource(drv)
    feed = SpectrumFeed(sdr_chunks(src, 25_000, CPU), samp_rate=fs, fft_size=256,
                        realtime=False, device=CPU)
    srv = UiServer(feed, control=src.control()).start()
    try:
        assert json.loads(_get(srv.address + "/api/meta"))["control"] is True
        applied = json.loads(_get(srv.address + "/api/retune?frequency=2000000&gain=0.5"))
        assert applied == {"frequency": 2000000.0, "gain": 0.5}
        deadline = time.time() + 10
        while time.time() < deadline and drv.frequency != 2_000_000.0:
            time.sleep(0.05)
        assert drv.frequency == 2_000_000.0 and drv.gain == 0.5
        assert json.loads(_get(srv.address + "/api/meta"))["center_freq"] == 2_000_000.0
    finally:
        feed.done = True
        srv.stop()
        feed.join(timeout=30)


def test_torch_ui_ws_pushes_frames():
    feed = SpectrumFeed(iter(_tone_chunks()), samp_rate=48_000.0, fft_size=256,
                        realtime=False, stats_fn=lambda: "stats over ws", device=CPU)
    srv = UiServer(feed).start()
    try:
        feed.join(timeout=30)
        host, port = srv.httpd.server_address[:2]

        async def go():
            reader, writer = await asyncio.open_connection(host, port)
            await pws.client_handshake(reader, writer, f"{host}:{port}", "/ws?since=0")
            rows, stats = [], None
            while len(rows) == 0 or stats is None:
                op, payload = await asyncio.wait_for(pws.read_frame(reader), timeout=10)
                if op != pws.OP_BINARY:
                    continue
                body = json.loads(payload.decode())
                rows.extend(body.get("rows", []))
                stats = body.get("stats", stats)
            writer.close()
            return rows, stats

        rows, stats = asyncio.run(asyncio.wait_for(go(), timeout=20))
        assert len(bytes.fromhex(rows[-1])) == 256 and stats == "stats over ws"
    finally:
        srv.stop()


# ---- the apps

def _fm_u8(fs=250_000.0, n=25_000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    iq = 0.4 * np.exp(2j * np.pi * 5_000.0 * t) + 0.05 * (rng.randn(n) + 1j * rng.randn(n))
    return rawfile.rtlsdr_encode(iq.astype(np.complex64))


def test_torch_downsample_u8_within_one_lsb_of_jax():
    fs, ds_rate = 250_000.0, 50_000.0
    raw = _fm_u8(fs, 50_000)
    got = np.frombuffer(rds.downsample_u8(raw, fs, ds_rate, device=CPU), np.uint8)
    want = np.frombuffer(jrds.downsample_u8(raw, fs, ds_rate), np.uint8)
    assert got.shape == want.shape and abs(len(got) - len(raw) / 5) < 400
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1  # FFT against direct FIR: rounding boundaries only
    assert (diff > 0).sum() <= 0.01 * len(got)
    with pytest.raises(ValueError, match="device="):
        rds.downsample_u8(raw, fs, ds_rate)  # a numpy input names its device
    # the payload survives DATA_STREAM framing with credit windows
    sent = []
    writer = pds.SyncWriter(sent.append)
    writer.grant("rtl-sdr", len(got))
    assert writer.send("rtl-sdr", got.tobytes()) == len(got)
    events = pds.BytesReader().feed(b"".join(sent))
    assert b"".join(e[2] for e in events if e[0] == "data") == got.tobytes()


def _data_of(wire: bytes) -> bytes:
    events = pds.BytesReader().feed(wire)
    assert events[0] == ("version", 0)
    return b"".join(e[2] for e in events if e[0] == "data")


def test_torch_rtl_data_stream_stdio_loop(tmp_path):
    raw = _fm_u8()
    path = tmp_path / "c.u8"
    raw.tofile(path)
    payload = rds.downsample_u8(raw, 250_000.0, 50_000.0, device=CPU)
    ctl = pds.encode_version() + pds.encode_request_data("rtl-sdr", 3000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "rustradio_tpu_torch.apps.rtl_data_stream",
                        "-r", str(path), "--packet-bytes", "1000", "--device", "cpu"],
                       input=ctl, capture_output=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    events = pds.BytesReader().feed(r.stdout)
    assert [len(e[2]) for e in events if e[0] == "data"] == [1000, 1000, 1000]
    assert _data_of(r.stdout) == payload[:3000]  # the credit, no more
    # in process: the whole payload for a window that covers it, and a
    # replacing window of 0 stops the stream
    import io

    out = io.BytesIO()
    rds.serve_stdio(payload, io.BytesIO(pds.encode_version() + pds.encode_request_data(
        "rtl-sdr", 10 ** 9)), out, packet_bytes=4096)
    assert _data_of(out.getvalue()) == payload


def test_torch_rtl_data_stream_tcp_clients():
    payload = rds.downsample_u8(_fm_u8(), 250_000.0, 50_000.0, device=CPU)

    async def go():
        srv = pds.DataStreamServer(rds.payload_reader(payload, False), "rtl-sdr", 4096)
        _, port = await srv.serve()
        got = await asyncio.gather(*[_client(pds, port, 1 << 30, len(payload))
                                     for _ in range(4)])
        await srv.close()
        return got

    assert asyncio.run(asyncio.wait_for(go(), timeout=30)) == [payload] * 4
    at = rds.payload_reader(b"abcdef", True)
    assert at(4, 4) == b"ef" and at(8, 2) == b"cd"
    assert rds.payload_reader(b"abc", False)(3, 5) == b""


def test_torch_ui_server_app_serves_rows(tmp_path):
    iq = np.concatenate(_tone_chunks())
    path = tmp_path / "t.c32"
    iq.tofile(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rustradio_tpu_torch.apps.ui_server", "-r", str(path),
         "--sample_rate", "48k", "--fft_size", "256", "--port", "0", "--once",
         "--device", "cpu"], cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.time() + 60
        while "serving on" not in line and time.time() < deadline:
            line = proc.stderr.readline()
            assert line or proc.poll() is None, "ui_server exited"
        url = line.split("serving on", 1)[1].strip()
        rows = []
        while not rows and time.time() < deadline:
            rows = json.loads(_get(url + "/api/frames?since=0"))["rows"]
            time.sleep(0.1)
        assert rows and len(bytes.fromhex(rows[0])) == 256
    finally:
        proc.kill()
        proc.wait(timeout=10)
