"""I/O and misc blocks (port of ``rustradio_tpu/blocks/io_blocks.py``): the
.au codec, the RTL-SDR codec, the CMA equalizer, TCP/reader/writer and
strobe.

Reference: src/au.rs, src/rtlsdr_decode.rs, src/rtlsdr_encode.rs,
src/cma.rs, src/tcp_source.rs, src/reader_source.rs, src/writer_sink.rs,
src/strobe.rs.

Host blocks return their outputs on their input's device, host sources on
the run's device.  Every thread and socket here waits at most ``timeout``
seconds for its peer, so a feed that stalls fails the run instead of
hanging it.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading

import numpy as np
import torch

from .. import native
from ..io import rawfile
from ..io.au import au_decode
from ..ops.cma import cma_equalize
from ..streams import Pdu
from .base import Block, SourceBlock

def _host_bytes(x) -> bytes:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.uint8).tobytes()


def _device_of(x):
    return x.device if torch.is_tensor(x) else torch.device("cpu")


class AuDecode(Block):
    """.au bytes -> float samples (reference src/au.rs:196-285).

    Streaming-capable: carries header parse state and an odd trailing byte.
    """

    graph_capturable = False  # host: parses bytes
    domain = "host"

    def __init__(self, bitrate: int):
        self.bitrate = bitrate
        self._header_done = False
        self._buf = b""

    def apply(self, x):
        samples, _ = au_decode(_host_bytes(x), self.bitrate)
        return torch.from_numpy(samples).to(_device_of(x))

    def init_state(self):
        self._header_done = False
        self._buf = b""
        return None

    def apply_chunk(self, state, x):
        dev = _device_of(x)
        self._buf += _host_bytes(x)
        empty = torch.zeros(0, dtype=torch.float32, device=dev)
        if not self._header_done:
            if len(self._buf) < 24:
                return None, empty
            magic, offset = struct.unpack(">II", self._buf[:8])
            if magic != 0x2E736E64:
                raise ValueError(".au magic value not found")
            if len(self._buf) < offset:
                return None, empty
            enc, rate, _chans = struct.unpack(">III", self._buf[12:24])
            if enc != 3:
                raise ValueError("only PCM16 encoding supported")
            if rate != self.bitrate:
                raise ValueError(f"AU expected bitrate {self.bitrate}, got {rate}")
            self._buf = self._buf[offset:]
            self._header_done = True
        n = len(self._buf) // 2
        pcm = np.frombuffer(self._buf[: 2 * n], dtype=">i2").astype(np.float32)
        self._buf = self._buf[2 * n :]
        return None, torch.from_numpy(pcm / np.float32(32767.0)).to(dev)


class AuEncode(Block):
    """float samples -> .au bytes (reference src/au.rs:51-154)."""

    graph_capturable = False  # host: native PCM conversion
    domain = "host"

    def __init__(self, bitrate: int, channels: int = 1):
        if channels != 1:
            raise ValueError("only mono supported at the moment")
        self.bitrate = bitrate
        self._header_sent = False

    def _header(self) -> np.ndarray:
        h = struct.pack(
            ">IIIIII4x", 0x2E736E64, 28, 0xFFFFFFFF, 3, self.bitrate, 1
        )
        return np.frombuffer(h, np.uint8)

    @staticmethod
    def _pcm(x) -> np.ndarray:
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        return native.convert_f32_i16be(np.asarray(x, np.float32))

    def apply(self, x):
        out = np.concatenate([self._header(), self._pcm(x)])
        return torch.from_numpy(out).to(_device_of(x))

    def init_state(self):
        self._header_sent = False
        return None

    def apply_chunk(self, state, x):
        pcm = self._pcm(x)
        if not self._header_sent:
            self._header_sent = True
            pcm = np.concatenate([self._header(), pcm])
        return None, torch.from_numpy(pcm).to(_device_of(x))


class RtlSdrDecode(Block):
    """u8 offset-127 IQ -> complex64 (reference src/rtlsdr_decode.rs), on
    the stream's device (``io.rawfile.rtlsdr_decode``)."""

    graph_capturable = True  # elementwise on the card

    def apply(self, x):
        return rawfile.rtlsdr_decode(torch.as_tensor(x))


class RtlSdrEncode(Block):
    """complex64 -> u8 offset-127 IQ (reference src/rtlsdr_encode.rs), on
    the stream's device (``io.rawfile.rtlsdr_encode``)."""

    graph_capturable = True  # elementwise on the card

    def apply(self, x):
        return rawfile.rtlsdr_encode(torch.as_tensor(x))


class CmaEqualizer(Block):
    """CMA blind equalizer (reference src/cma.rs): ``ops.cma_equalize``,
    kernel F on the chunk's device.

    Streaming state ``{"taps", "carry"}``: the taps the last window left,
    and the last ntaps - 1 samples, which start the next chunk's windows.
    A stream shorter than one window gives no output yet.  Kernel F's
    blocks of 32 windows count from each call's start, so a stream cut
    into chunks rounds in another order than one call over the same
    samples (bit for bit the same where every cut falls after a multiple
    of 32 windows).  The gap grows with the stream's length, as the f32
    recurrence's rounding drifts along CMA's free phase: about 1e-6 of
    max|y| over 2^14 windows, a few 1e-6 over 2^22 (PERF.md)."""

    graph_capturable = False  # the output is shorter than the input
    domain = "host"  # as in the JAX package: the output length varies

    def __init__(self, ntaps: int, desired_modulus: float = 1.0,
                 step_size: float = 1e-3):
        if ntaps == 0:
            raise ValueError("ntaps must be nonzero")
        self.ntaps = ntaps
        self.desired_modulus = desired_modulus
        self.step_size = step_size

    def apply(self, x):
        y, _ = cma_equalize(x, self.ntaps, self.desired_modulus, self.step_size)
        return y

    def init_state(self):
        taps = torch.zeros(self.ntaps, dtype=torch.complex64)
        taps[0] = 1.0
        return {"taps": taps, "carry": torch.zeros(0, dtype=torch.complex64)}

    def apply_chunk(self, state, x):
        x = torch.as_tensor(x).to(torch.complex64)
        buf = torch.cat([state["carry"].to(x.device), x])
        taps = state["taps"].to(x.device)
        if buf.shape[0] < self.ntaps:
            return {"taps": taps, "carry": buf}, buf[:0]
        y, taps = cma_equalize(buf, self.ntaps, self.desired_modulus,
                               self.step_size, taps=taps)
        carry = buf[buf.shape[0] - (self.ntaps - 1):].clone()
        return {"taps": taps, "carry": carry}, y


class Strobe(SourceBlock):
    """Periodic message emitter (reference src/strobe.rs): in the static
    schedule, n copies of a PDU."""

    graph_capturable = False  # a source of PDUs
    domain = "host"

    def __init__(self, message, count: int = 1):
        self.message = np.asarray(message)
        self.count = count

    def total_len(self):
        return self.count

    def emit(self, offset, n, device=None):
        return [Pdu(self.message.copy()) for _ in range(n)]


class ReaderSource(SourceBlock):
    """Any readable byte object -> u8 stream (reference src/reader_source.rs).

    Streams via a background thread and a bounded queue, like the
    reference's thread + mpsc channel (src/reader_source.rs:24-47): the
    reader is never slurped whole, and memory is bounded by the queue
    depth.  ``n=None`` makes the source unbounded (use ``max_chunks`` or
    Head); the stream ends early at reader EOF via ``exhausted()``.  A
    reader that raises fails the run with its exception; one that gives
    nothing for ``timeout`` seconds fails it with ``TimeoutError``.
    """

    graph_capturable = False  # a source: reads a host stream
    domain = "host"

    def __init__(self, reader, n: int | None = None, read_size: int = 65536,
                 queue_depth: int = 4, timeout: float = 60.0):
        self.reader = reader
        self.n = n
        self.timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._buf = bytearray()
        self._eof = False

        def pump():
            try:
                while True:
                    data = reader.read(read_size)
                    self._q.put(data)
                    if not data:
                        return
            except Exception as e:  # handed to the consumer
                self._q.put(e)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def total_len(self):
        return self.n

    def exhausted(self) -> bool:
        return self._eof and not self._buf

    def _take(self, n: int) -> np.ndarray:
        while len(self._buf) < n and not self._eof:
            try:
                data = self._q.get(timeout=self.timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"ReaderSource: no data for {self.timeout} s") from None
            if isinstance(data, Exception):
                raise data
            if not data:
                self._eof = True
                break
            self._buf.extend(data)
        take = min(n, len(self._buf))
        out = np.frombuffer(bytes(self._buf[:take]), np.uint8)
        del self._buf[:take]
        return out

    def emit(self, offset, n, device):
        return torch.from_numpy(self._take(n).copy()).to(device)

    def apply(self, device):
        # offline mode: drain the reader to EOF
        if self.n is not None:
            return self.emit(0, self.n, device)
        parts = []
        while not self.exhausted():
            out = self._take(65536)
            if len(out):
                parts.append(out)
        data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return torch.from_numpy(data).to(device)


class WriterSink(Block):
    """Any writable object sink (reference src/writer_sink.rs)."""

    graph_capturable = False  # host: writes
    n_out = 0
    domain = "host"

    def __init__(self, writer):
        self.writer = writer

    def apply(self, x):
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        self.writer.write(np.asarray(x).tobytes())
        return ()


class TcpSource(SourceBlock):
    """TCP client source (reference src/tcp_source.rs): connects and
    streams bytes.

    Memory is bounded: received bytes are dropped once consumed (the graph
    reads sequentially).  ``max_bytes=None`` streams until the peer closes
    (use ``max_chunks``); the stream ends early via ``exhausted()``.  The
    connection and every receive wait at most ``timeout`` seconds
    (``TimeoutError``)."""

    graph_capturable = False  # a source: reads a socket
    domain = "host"

    def __init__(self, host: str, port: int, max_bytes: int | None = None,
                 timeout: float = 60.0):
        self.host, self.port, self.max_bytes = host, port, max_bytes
        self.timeout = timeout
        self._sock = None
        self._buf = bytearray()
        self._base = 0  # stream offset of _buf[0]
        self._eof = False

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=self.timeout)
        return self._sock

    def total_len(self):
        return self.max_bytes

    def exhausted(self) -> bool:
        return self._eof and not self._buf

    def emit(self, offset, n, device):
        if offset < self._base:
            raise ValueError("TcpSource is sequential; cannot re-read old bytes")
        s = self._connect()
        need = offset + n - (self._base + len(self._buf))
        while need > 0 and not self._eof:
            chunk = s.recv(min(65536, need))
            if not chunk:
                self._eof = True
                break
            self._buf.extend(chunk)
            need -= len(chunk)
        lo = offset - self._base
        hi = min(lo + n, len(self._buf))
        out = np.frombuffer(bytes(self._buf[lo:hi]), np.uint8).copy()
        # drop consumed bytes: memory stays bounded on long-running feeds
        del self._buf[:hi]
        self._base += hi
        return torch.from_numpy(out).to(device)
