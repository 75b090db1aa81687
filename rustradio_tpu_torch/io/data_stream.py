"""The framed multi-stream byte protocol (reference DATA_STREAM.md +
src/data_stream.rs); a stdlib copy of ``rustradio_tpu/io/data_stream.py``.

Little-endian framing over any bidirectional byte transport:

    u32 packet_len; u8 packet_type; u8[packet_len-1] body

Types: Version=1 (u32 version, must be first both ways), RequestData=2
(u32 window + stream id; credit-based flow control), Data=3
(u32 stream_id_len + id + bytes).  Payloads over 64 MiB rejected.
"""

from __future__ import annotations

import struct
from typing import Callable

MAX_PACKET = 64 * 1024 * 1024
VERSION = 0
T_VERSION, T_REQUEST_DATA, T_DATA = 1, 2, 3


class ProtocolError(ValueError):
    pass


def encode_version() -> bytes:
    return struct.pack("<IBI", 5, T_VERSION, VERSION)


def encode_request_data(stream_id: str, window: int) -> bytes:
    sid = stream_id.encode()
    return struct.pack("<IBI", 1 + 4 + len(sid), T_REQUEST_DATA, window) + sid


def encode_data(stream_id: str, data: bytes) -> bytes:
    sid = stream_id.encode()
    return (
        struct.pack("<IBI", 1 + 4 + len(sid) + len(data), T_DATA, len(sid))
        + sid
        + data
    )


class BytesReader:
    """Byte-fed incremental parser (reference src/data_stream.rs BytesReader).

    Feed arbitrary byte chunks with ``feed``; parsed packets come out as
    ("version", v) / ("request_data", id, window) / ("data", id, bytes).
    """

    def __init__(self, max_packet: int = MAX_PACKET):
        self._buf = bytearray()
        self.max_packet = max_packet
        self._got_version = False

    def feed(self, data: bytes):
        self._buf.extend(data)
        out = []
        while True:
            if len(self._buf) < 4:
                break
            (plen,) = struct.unpack_from("<I", self._buf, 0)
            if plen == 0:
                raise ProtocolError("zero-length packet")
            if plen > self.max_packet:
                raise ProtocolError(f"packet of {plen} bytes exceeds cap")
            if len(self._buf) < 4 + plen:
                break
            body = bytes(self._buf[5 : 4 + plen])
            ptype = self._buf[4]
            del self._buf[: 4 + plen]
            out.append(self._parse(ptype, body))
        return out

    def _parse(self, ptype: int, body: bytes):
        if not self._got_version and ptype != T_VERSION:
            raise ProtocolError("first packet must be Version")
        if ptype == T_VERSION:
            if len(body) != 4:
                raise ProtocolError("bad Version packet")
            (v,) = struct.unpack("<I", body)
            if v != VERSION:
                raise ProtocolError(f"unsupported version {v}")
            self._got_version = True
            return ("version", v)
        if ptype == T_REQUEST_DATA:
            if len(body) < 4:
                raise ProtocolError("bad RequestData packet")
            (window,) = struct.unpack_from("<I", body, 0)
            sid = body[4:].decode()  # raises on invalid UTF-8, like reference
            return ("request_data", sid, window)
        if ptype == T_DATA:
            if len(body) < 4:
                raise ProtocolError("bad Data packet")
            (sid_len,) = struct.unpack_from("<I", body, 0)
            if 4 + sid_len > len(body):
                raise ProtocolError("bad Data stream id length")
            sid = body[4 : 4 + sid_len].decode()
            return ("data", sid, body[4 + sid_len :])
        raise ProtocolError(f"unknown packet type {ptype}")


class SyncWriter:
    """Writer with per-stream credit windows (reference SyncWriter)."""

    def __init__(self, write: Callable[[bytes], None]):
        self._write = write
        self.windows: dict[str, int] = {}
        self._write(encode_version())

    def grant(self, stream_id: str, window: int):
        """Apply a received RequestData (replaces the previous window)."""
        self.windows[stream_id] = window

    def send(self, stream_id: str, data: bytes) -> int:
        """Send as much of ``data`` as the window allows; returns bytes sent."""
        w = self.windows.get(stream_id, 0)
        n = min(w, len(data))
        if n == 0:
            return 0
        self._write(encode_data(stream_id, bytes(data[:n])))
        self.windows[stream_id] = w - n
        return n


class AsyncWriter:
    """Asyncio DATA_STREAM writer (reference src/data_stream.rs:643-716
    asynchronous::AsyncWriter over tokio)."""

    def __init__(self, writer):
        self._w = writer  # asyncio.StreamWriter

    async def write_version(self):
        self._w.write(encode_version())
        await self._w.drain()

    async def write_request_data(self, stream_id: str, window: int):
        self._w.write(encode_request_data(stream_id, window))
        await self._w.drain()

    async def write_data(self, stream_id: str, data: bytes):
        self._w.write(encode_data(stream_id, data))
        await self._w.drain()


class AsyncReader:
    """Asyncio DATA_STREAM reader (reference src/data_stream.rs:591-641
    asynchronous::AsyncReader).

    ``read_packet`` awaits one full frame and returns the parsed tuple,
    or None at a clean EOF between packets.
    """

    def __init__(self, reader, max_packet: int = MAX_PACKET):
        self._r = reader  # asyncio.StreamReader
        self._parser = BytesReader(max_packet)
        self.max_packet = max_packet

    async def read_packet(self):
        import asyncio

        try:
            hdr = await self._r.readexactly(4)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean EOF between packets
            raise ProtocolError("EOF inside packet header") from e
        (plen,) = struct.unpack("<I", hdr)
        if plen == 0:
            raise ProtocolError("zero-length packet")
        if plen > self.max_packet:
            raise ProtocolError(f"packet of {plen} bytes exceeds cap")
        try:
            body = await self._r.readexactly(plen)
        except asyncio.IncompleteReadError as e:
            raise ProtocolError("EOF inside packet body") from e
        return self._parser._parse(body[0], body[1:])

    async def read_version(self) -> bool:
        pkt = await self.read_packet()
        if pkt is None:
            return False
        if pkt[0] != "version":
            raise ProtocolError("first packet must be Version")
        return True


class DataStreamServer:
    """Nonblocking multi-client DATA_STREAM server (asyncio).

    The reference's agraph runs its I/O blocks on a tokio runtime; this is
    the counterpart for serving a byte stream to many concurrent clients:
    each connection gets its own position and credit window, so a slow or
    idle client never blocks the others.

    ``payload_fn(pos, n) -> bytes`` supplies stream bytes (return b"" to
    end that client's stream; loop internally for a live/repeating feed).
    """

    def __init__(self, payload_fn, stream_id: str = "rtl-sdr",
                 packet_bytes: int = 16_384):
        self.payload_fn = payload_fn
        self.stream_id = stream_id
        self.packet_bytes = packet_bytes
        self.clients = 0
        self._server = None

    async def _wrap(self, reader, writer):
        """Transport hook: adapt the raw TCP pair before DATA_STREAM runs
        over it (the websocket server overrides this with the RFC 6455
        handshake + frame adapters)."""
        return reader, writer

    async def _handle(self, reader, writer):
        import asyncio

        self.clients += 1
        try:
            reader, writer = await self._wrap(reader, writer)
        except Exception:
            self.clients -= 1
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass
            return
        r = AsyncReader(reader)
        w = AsyncWriter(writer)
        try:
            await w.write_version()
            if not await r.read_version():
                return
            window = 0
            window_changed = asyncio.Event()

            async def control():
                nonlocal window
                while True:
                    pkt = await r.read_packet()
                    if pkt is None:
                        break
                    if pkt[0] == "request_data" and pkt[1] == self.stream_id:
                        window = pkt[2]  # replaces the previous window
                        window_changed.set()
                window_changed.set()

            ctl = asyncio.ensure_future(control())
            pos = 0
            try:
                while not ctl.done():
                    if window <= 0:
                        window_changed.clear()
                        await window_changed.wait()
                        continue
                    n = min(window, self.packet_bytes)
                    data = self.payload_fn(pos, n)
                    if not data:
                        break
                    await w.write_data(self.stream_id, data)
                    pos += len(data)
                    window -= len(data)
                    await asyncio.sleep(0)  # yield between sends
            finally:
                ctl.cancel()
        except (ProtocolError, ConnectionError, OSError):
            pass
        finally:
            self.clients -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start serving; returns the bound (host, port)."""
        import asyncio

        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[:2]

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


class WsDataStreamServer(DataStreamServer):
    """DATA_STREAM served over websockets (reference src/data_stream.rs
    websocket support, consumed by rustradio-ui/src/worker/source.rs):
    the same credit-flow server with the RFC 6455 handshake + binary
    frame adapters layered under it.  Browser clients connect with a
    plain ``WebSocket`` and speak the identical framed protocol."""

    async def _wrap(self, reader, writer):
        from .websocket import WsByteReader, WsByteWriter, server_handshake

        await server_handshake(reader, writer)
        # server side: RFC 6455 requires every client->server frame to be
        # masked; unmasked ones are rejected with close 1002
        return (
            WsByteReader(reader, writer, require_masked=True),
            WsByteWriter(writer),
        )


class SyncReader:
    """Reader that pulls with RequestData (reference SyncReader)."""

    def __init__(self, write: Callable[[bytes], None], max_packet: int = MAX_PACKET):
        self._write = write
        self._parser = BytesReader(max_packet)
        self.received: dict[str, bytearray] = {}
        self._write(encode_version())

    def request(self, stream_id: str, window: int):
        self._write(encode_request_data(stream_id, window))

    def feed(self, data: bytes):
        events = self._parser.feed(data)
        for ev in events:
            if ev[0] == "data":
                self.received.setdefault(ev[1], bytearray()).extend(ev[2])
        return events

    def take(self, stream_id: str) -> bytes:
        buf = self.received.pop(stream_id, bytearray())
        return bytes(buf)
