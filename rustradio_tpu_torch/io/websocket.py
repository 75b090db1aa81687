"""Minimal RFC 6455 websocket transport for the DATA_STREAM protocol (a
stdlib copy of ``rustradio_tpu/io/websocket.py``, whose server side
accepts unmasked control frames; here it rejects every unmasked client
frame, as RFC 6455 section 5.1 asks).

The reference serves its framed byte protocol over websockets so the
browser UI can stream samples (src/data_stream.rs websocket reader/
writer; consumed by rustradio-ui/src/worker/source.rs).  This module is
the asyncio counterpart, implemented directly on the stdlib (no external
websocket dependency): the HTTP Upgrade handshake, binary frames with
16/64-bit lengths, client->server masking, ping/pong, and close.

``WsByteReader``/``WsByteWriter`` adapt a websocket connection to the
byte interface ``data_stream.AsyncReader``/``AsyncWriter`` expect, so
the SAME credit-flow DATA_STREAM machinery runs unchanged over TCP or
websockets — one protocol, two transports, like the reference.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


class WsError(ConnectionError):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


async def _read_http_headers(reader) -> dict[str, str]:
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    headers = {"_start": lines[0]}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return headers


async def server_handshake(reader, writer) -> str:
    """Accept a websocket upgrade; returns the request path."""
    h = await _read_http_headers(reader)
    start = h["_start"].split()
    if len(start) < 2 or h.get("upgrade", "").lower() != "websocket":
        writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        await writer.drain()
        raise WsError("not a websocket upgrade")
    key = h.get("sec-websocket-key")
    if not key:
        raise WsError("missing Sec-WebSocket-Key")
    writer.write(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        ).encode()
    )
    await writer.drain()
    return start[1]


async def client_handshake(reader, writer, host: str, path: str = "/") -> None:
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write(
        (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode()
    )
    await writer.drain()
    h = await _read_http_headers(reader)
    if "101" not in h["_start"]:
        raise WsError(f"handshake rejected: {h['_start']}")
    if h.get("sec-websocket-accept") != accept_key(key):
        raise WsError("bad Sec-WebSocket-Accept")


def encode_frame(payload: bytes, opcode: int = OP_BINARY, mask: bool = False) -> bytes:
    b0 = 0x80 | opcode  # FIN
    n = len(payload)
    if n < 126:
        hdr = struct.pack("!BB", b0, (0x80 if mask else 0) | n)
    elif n < 1 << 16:
        hdr = struct.pack("!BBH", b0, (0x80 if mask else 0) | 126, n)
    else:
        hdr = struct.pack("!BBQ", b0, (0x80 if mask else 0) | 127, n)
    if not mask:
        return hdr + payload
    key = os.urandom(4)
    masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return hdr + key + masked


# Frames larger than this are a protocol violation: DATA_STREAM packets
# cap at 64 MiB (io/data_stream.py, spec DATA_STREAM.md) and our writers
# emit one packet per frame, so anything bigger is hostile input — the
# attacker-controlled 64-bit length must never commit us to buffering an
# arbitrarily large payload.
MAX_FRAME = (64 << 20) + 1024


async def read_frame(reader, *, require_masked: bool = False) -> tuple[int, bytes]:
    """One complete frame -> (opcode, unmasked payload).  Raises
    IncompleteReadError at EOF, WsError on oversize frames or (with
    ``require_masked``, the server side) on any unmasked client frame,
    data or control, which RFC 6455 5.1 requires rejecting."""
    b0, b1 = await reader.readexactly(2)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", await reader.readexactly(8))
    if n > MAX_FRAME:
        raise WsError(f"frame length {n} exceeds cap {MAX_FRAME}")
    if require_masked and not masked:
        raise WsError(f"unmasked client frame, opcode {opcode} (RFC 6455 5.1)")
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, payload


class WsByteWriter:
    """asyncio.StreamWriter-shaped adapter: bytes out as binary frames."""

    def __init__(self, writer, mask: bool = False):
        self._w = writer
        self._mask = mask

    def write(self, data: bytes) -> None:
        self._w.write(encode_frame(bytes(data), OP_BINARY, self._mask))

    async def drain(self) -> None:
        await self._w.drain()

    async def close_ws(self, code: int = 1000) -> None:
        try:
            self._w.write(encode_frame(struct.pack("!H", code), OP_CLOSE, self._mask))
            await self._w.drain()
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._w.close()

    async def wait_closed(self) -> None:
        await self._w.wait_closed()


class WsByteReader:
    """asyncio.StreamReader-shaped adapter: binary frames in, bytes out.

    Control frames are handled transparently (pong replies ride
    ``writer``; a close frame or EOF surfaces as IncompleteReadError so
    data_stream.AsyncReader sees a clean end-of-stream).
    """

    def __init__(self, reader, writer=None, mask_replies: bool = False,
                 require_masked: bool = False):
        self._r = reader
        self._w = writer
        self._mask = mask_replies
        self._require_masked = require_masked
        self._buf = bytearray()
        self._eof = False

    async def _fill(self) -> bool:
        while True:
            try:
                opcode, payload = await read_frame(
                    self._r, require_masked=self._require_masked
                )
            except WsError:
                # protocol violation (oversize frame / unmasked client
                # frame): close 1002 and end the stream
                if self._w is not None:
                    try:
                        self._w.write(
                            encode_frame(struct.pack("!H", 1002), OP_CLOSE,
                                         self._mask)
                        )
                        await self._w.drain()
                    except (ConnectionError, OSError):
                        pass
                self._eof = True
                return False
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                self._eof = True
                return False
            if opcode in (OP_BINARY, OP_TEXT, OP_CONT):
                self._buf.extend(payload)
                if payload:
                    return True
            elif opcode == OP_PING and self._w is not None:
                self._w.write(encode_frame(payload, OP_PONG, self._mask))
                await self._w.drain()
            elif opcode == OP_CLOSE:
                self._eof = True
                return False

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            if self._eof or not await self._fill():
                partial = bytes(self._buf)
                self._buf.clear()
                raise asyncio.IncompleteReadError(partial, n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


async def ws_connect(host: str, port: int, path: str = "/"):
    """Client connect + handshake; returns (WsByteReader, WsByteWriter)
    ready to carry DATA_STREAM (client frames are masked per RFC 6455)."""
    reader, writer = await asyncio.open_connection(host, port)
    await client_handshake(reader, writer, f"{host}:{port}", path)
    return WsByteReader(reader, writer, mask_replies=True), WsByteWriter(
        writer, mask=True
    )
