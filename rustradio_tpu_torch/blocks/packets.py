"""Packet and PDU blocks (port of ``rustradio_tpu/blocks/packets.py``:
HDLC framing and deframing, the IL2P header deframer, the burst blocks
``BurstTagger`` / ``StreamToPdu`` / ``PduToStream``, whole-packet clock
recovery ``Midpointer`` / ``Wpcr``, the KISS framing, the FFT blocks
``Fft`` / ``FftStream``, ``PduWriter``, ``MorseEncode``, ``Hasher``,
``ToText`` and ``Canary``).  PDU streams flow between host blocks as lists
of :class:`~rustradio_tpu_torch.streams.Pdu`; a PDU cut from a device
stream keeps its samples on that device.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from ..ops import hdlc
from ..ops.burst import burst_tagger
from ..ops.fft import fft_pdu, fft_stream
from ..ops.hdlc import HdlcStateMachine
from ..ops.il2p import HEADER_BITS, SYNC_WORD, il2p_deframe
from ..ops.wpcr import midpoint_batch, wpcr_batch
from ..streams import Pdu, Tag
from .base import Block

KISS_FEND, KISS_FESC, KISS_TFEND, KISS_TFESC = 0xC0, 0xDB, 0xDC, 0xDD


def _host_bytes(data) -> np.ndarray:
    """A PDU's data as host uint8 numpy."""
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    return np.asarray(data, np.uint8)


class HdlcDeframer(Block):
    """Bit stream -> packet PDUs (reference src/hdlc_deframer.rs), each
    tagged with its frame-end bit position (``packet_pos``).  The resumable
    state machine carries frames across chunk boundaries; its snapshot is
    the streaming (and checkpointed) state."""

    graph_capturable = False  # host: bits read back for the deframer
    domain = "host"

    def __init__(self, min_size: int = 10, max_size: int = 1500,
                 fix_bits: bool = False, keep_checksum: bool = False):
        self.min_size, self.max_size = min_size, max_size
        self.fix_bits, self.keep_checksum = fix_bits, keep_checksum
        self._sm = self._machine()

    def _machine(self) -> HdlcStateMachine:
        return HdlcStateMachine(self.min_size, self.max_size,
                                self.keep_checksum, self.fix_bits)

    @property
    def stats(self):
        return self._sm.stats

    @staticmethod
    def _emit(pkts):
        return [Pdu(d, [Tag(0, "packet_pos", int(p))]) for d, p in pkts]

    def apply(self, x):
        return self._emit(self._sm.feed(x))

    def init_state(self):
        self._sm = self._machine()
        return self._sm.snapshot()

    def apply_chunk(self, state, x):
        self._sm.restore(state)
        pdus = self._emit(self._sm.feed(x))
        return self._sm.snapshot(), pdus


class HdlcFramer(Block):
    """Packet PDU -> stuffed bit PDU (reference src/hdlc_framer.rs)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def __init__(self, sync_bytes: int = 20):
        self.sync_bytes = sync_bytes

    def apply(self, pdus):
        return [Pdu(hdlc.hdlc_frame(_host_bytes(p.data), self.sync_bytes), p.tags)
                for p in pdus]


class FcsAdder(Block):
    """Append CRC-16 (reference src/hdlc_framer.rs:28-42)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def apply(self, pdus):
        return [Pdu(hdlc.fcs_add(_host_bytes(p.data)), p.tags) for p in pdus]


class BurstTagger(Block):
    """Adds 'burst' true/false tags to the data stream where the trigger
    stream crosses the threshold (reference src/burst_tagger.rs).  The
    compare runs on the trigger's device, the edges' positions come to the
    host as tags; carries the last comparison."""

    graph_capturable = False  # host: the burst edges read back
    n_in = 2
    domain = "host"

    def __init__(self, threshold: float, tag: str = "burst"):
        self.threshold = threshold
        self.tag = tag
        self._last = False
        self._edge_tags: list[Tag] = []

    def init_state(self):
        self._last = False
        return {"last": False}

    def apply_chunk(self, state, data, trigger):
        self._last = bool(state["last"])
        out = self.apply(data, trigger)
        return {"last": self._last}, out

    def apply(self, data, trigger):
        start, end = burst_tagger(trigger, self.threshold, last=self._last)
        edges = torch.stack([start, end]).cpu().numpy()
        on, off = np.flatnonzero(edges[0]), np.flatnonzero(edges[1])
        # the chunk's last comparison: the kind of its last edge (a start
        # and an end never share a sample), or the carried one without any
        if on.size or off.size:
            self._last = bool((on[-1] if on.size else -1)
                              > (off[-1] if off.size else -1))
        self._edge_tags = sorted(
            [Tag(int(i), self.tag, True) for i in on]
            + [Tag(int(i), self.tag, False) for i in off]
        )
        return data

    def process_tags(self, in_tags, out_lens):
        base = list(in_tags[0]) if in_tags else []
        return [sorted(base + self._edge_tags)]


class StreamToPdu(Block):
    """Tagged stream -> burst PDUs (reference src/stream_to_pdu.rs).

    Carries the reference's Unsync/Packet/Tail state machine
    (src/stream_to_pdu.rs:10-26) across streaming chunks, so a burst that
    spans two ``run_stream`` chunks still becomes one PDU.  The tags it
    reads are chunk-relative, as ``run_stream`` hands them over.  Non-burst
    tags inside a burst are attached to the PDU with burst-relative
    positions (src/stream_to_pdu.rs:176-195 ``tags_pos_adjust``).  A burst's
    samples stay on the stream's device (the open burst's too, in the
    carried state ``{"mode", "buf", "tail_left", "tags"}``).
    """

    graph_capturable = False  # host: bursts cut at tags
    domain = "host"

    UNSYNC, PACKET, TAIL = 0, 1, 2

    def __init__(self, tag: str = "burst", max_size: int = 10_000, tail: int = 0):
        self.tag, self.max_size, self.tail = tag, max_size, tail
        self._last_state = None
        self._in_tags: list[Tag] = []

    def init_state(self):
        self._last_state = None
        return {"mode": self.UNSYNC, "buf": None, "tail_left": 0, "tags": []}

    def _other_tags(self, tags, lo, hi, base):
        """Tags (excluding the burst tag) in [lo, hi), re-based to the
        burst-relative position ``base + (pos - lo)``."""
        return [
            Tag(base + (t.pos - lo), t.key, t.val)
            for t in tags
            if t.key != self.tag and lo <= t.pos < hi
        ]

    def apply_chunk(self, state, x):
        n = x.shape[0]
        tags = self._in_tags
        start = np.zeros(n, bool)
        end = np.zeros(n, bool)
        for t in tags:
            if t.key == self.tag and 0 <= t.pos < n:
                if t.val:
                    start[t.pos] = True
                else:
                    end[t.pos] = True

        mode = int(state["mode"])
        buf = state["buf"]
        if buf is not None:
            buf = torch.as_tensor(buf).to(x.device)
        tail_left = int(state["tail_left"])
        btags = list(state["tags"])
        pdus: list[Pdu] = []

        def file_burst(b, bt):
            # reference file_burst drops oversized bursts
            # (src/stream_to_pdu.rs:111-124)
            if len(b) <= self.max_size:
                pdus.append(Pdu(b, bt))

        def grow(b, lo, hi):
            # bound memory on live streams: an open burst past max_size is
            # dropped at filing anyway, so stop storing (and collecting
            # tags) past max_size + 1
            nonlocal btags
            cur = 0 if b is None else len(b)
            if cur > self.max_size:
                return b
            btags = btags + self._other_tags(tags, lo, hi, cur)
            seg = x[lo:hi]
            out = seg.clone() if cur == 0 else torch.cat([b, seg])
            return out[: self.max_size + 1] if len(out) > self.max_size else out

        i = 0
        while i < n:
            if mode == self.TAIL:
                # burst tags are ignored while collecting the tail
                # (src/stream_to_pdu.rs:246-260)
                k = min(tail_left, n - i)
                buf = grow(buf, i, i + k)
                tail_left -= k
                i += k
                if tail_left == 0:
                    file_burst(buf, btags)
                    mode, buf, btags = self.UNSYNC, None, []
                continue
            if mode == self.UNSYNC:
                nexts = np.flatnonzero(start[i:])
                if nexts.size == 0:
                    break
                s = i + int(nexts[0])
                if end[s]:  # both on one sample (src/stream_to_pdu.rs:209-221)
                    if self.tail > 0:
                        buf = grow(None, s, s + 1)
                        tail_left = self.tail - 1
                        mode = self.TAIL if tail_left else self.UNSYNC
                        if tail_left == 0:
                            file_burst(buf, btags)
                            buf, btags = None, []
                    else:
                        file_burst(x[:0], [])
                    i = s + 1
                    continue
                mode, buf, btags = self.PACKET, x[:0].clone(), []
                i = s
                # fall through into PACKET handling from the start sample
            # PACKET: accumulate until the end tag; start tags inside a
            # packet are ignored (src/stream_to_pdu.rs:222-227)
            nexts = np.flatnonzero(end[i:])
            if nexts.size == 0:
                buf = grow(buf, i, n)
                break
            e = i + int(nexts[0])
            buf = grow(buf, i, e)
            if self.tail > 0:
                # the end-tagged sample is the first tail sample
                # (src/stream_to_pdu.rs:229-245)
                k = min(self.tail, n - e)
                buf = grow(buf, e, e + k)
                if k == self.tail:
                    file_burst(buf, btags)
                    mode, buf, btags = self.UNSYNC, None, []
                else:
                    mode, tail_left = self.TAIL, self.tail - k
                i = e + k
            else:
                file_burst(buf, btags)
                mode, buf, btags = self.UNSYNC, None, []
                i = e + 1

        new_state = {"mode": mode, "buf": buf, "tail_left": tail_left,
                     "tags": btags}
        self._last_state = new_state
        return new_state, pdus

    def flush_with_state(self, state):
        """End-of-stream drain: a burst whose TAIL was clipped by the end of
        the stream is filed truncated (it already saw its end tag).  An
        unterminated PACKET-state burst is dropped, like the reference
        waiting forever for its end tag.  Reads the carried state, so the
        drain is right after a checkpoint resume too."""
        s = state
        if s is None or int(s["mode"]) != self.TAIL or s["buf"] is None:
            return None
        if len(s["buf"]) > self.max_size:
            return None
        return [Pdu(s["buf"], list(s["tags"]))]

    def flush(self):
        # offline mode: apply() left the machine's end state on the instance
        s = self._last_state
        self._last_state = None
        return self.flush_with_state(s)

    def apply(self, x):
        # offline mode runs the same machine over the whole stream; the
        # graph's flush pass files an EOF-clipped tail afterwards
        _, pdus = self.apply_chunk(self.init_state(), x)
        return pdus

    def set_tags(self, tags):
        self._in_tags = tags


class PduToStream(Block):
    """PDU -> stream with start/end tags (reference src/pdu_to_stream.rs),
    on the PDUs' device."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def __init__(self):
        self._tags: list[Tag] = []

    def apply(self, pdus):
        self._tags = []
        if not pdus:
            return torch.zeros(0)
        arrs = [torch.as_tensor(p.data) for p in pdus]
        off = 0
        for a in arrs:
            self._tags.append(Tag(off, "PduToStream::start", True))
            off += len(a)
            self._tags.append(Tag(off - 1, "PduToStream::end", True))
        return torch.cat([a.to(arrs[0].device) for a in arrs])

    def process_tags(self, in_tags, out_lens):
        return [list(self._tags)]


class Midpointer(Block):
    """Re-centre bursts (reference src/wpcr.rs:44-82): all PDUs of a chunk
    in one batched call per length bucket (``ops.midpoint_batch``), on
    their device; a burst with an empty side is dropped."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def apply(self, pdus):
        if not pdus:
            return []
        results = midpoint_batch([_samples(p.data) for p in pdus])
        return [Pdu(centred, p.tags)
                for p, (centred, ok) in zip(pdus, results) if ok]


class Wpcr(Block):
    """Whole-packet clock recovery (reference src/wpcr.rs:105-215): all PDUs
    of a chunk in one batched call per length bucket (``ops.wpcr_batch``
    without its midpoint stage: pair with Midpointer), on their device.
    Each found burst's symbols carry ``sps`` and ``phase`` tags (and
    ``frequency`` given ``samp_rate``)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def __init__(self, samp_rate: float | None = None):
        self.samp_rate = samp_rate

    def apply(self, pdus):
        if not pdus:
            return []
        results = wpcr_batch([_samples(p.data) for p in pdus],
                             midpoint_first=False)
        out = []
        for p, (syms, info) in zip(pdus, results):
            if not info["found"]:
                continue
            tags = [Tag(0, "sps", info["sps"]), Tag(0, "phase", info["phase"])]
            if self.samp_rate is not None:
                tags.append(Tag(0, "frequency", info["sps"] * self.samp_rate))
            out.append(Pdu(syms, p.tags + tags))
        return out


def _samples(data) -> torch.Tensor:
    """A PDU's samples as an f32 tensor (a numpy PDU on the CPU)."""
    if torch.is_tensor(data):
        return data.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(data, np.float32))


class KissEncode(Block):
    """Packet PDU -> KISS-framed PDU (reference src/kiss.rs escape())."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def apply(self, pdus):
        out = []
        for p in pdus:
            port = 0
            for t in p.tags:
                if t.key == "KissEncode:port":
                    port = int(t.val)
            b = [KISS_FEND, (port << 4) & 0xFF]
            for v in _host_bytes(p.data).tolist():
                if v == KISS_FEND:
                    b += [KISS_FESC, KISS_TFEND]
                elif v == KISS_FESC:
                    b += [KISS_FESC, KISS_TFESC]
                else:
                    b.append(v)
            b.append(KISS_FEND)
            out.append(Pdu(np.asarray(b, np.uint8), p.tags))
        return out


class KissFrame(Block):
    """Byte stream -> still-KISS-encoded frame PDUs
    (reference src/kiss.rs:160-229 KissFrame).

    Accumulates bytes between FEND delimiters across arbitrary chunk
    boundaries (Unsynced/Synced carried state); consecutive FENDs emit
    nothing; frames longer than ``max_len`` are dropped.  Normally
    followed by :class:`KissDecode`.
    """

    graph_capturable = False  # host: bytes
    domain = "host"

    def __init__(self, max_len: int = 10_000):
        self.max_len = max_len

    def init_state(self):
        return {"synced": False, "buf": b""}

    def apply_chunk(self, state, x):
        data = _host_bytes(x).tobytes()
        synced, buf = bool(state["synced"]), bytes(state["buf"])
        out: list[Pdu] = []
        i = 0
        if not synced:
            j = data.find(b"\xc0")
            if j < 0:
                return {"synced": False, "buf": b""}, out
            synced, i = True, j + 1
        while True:
            j = data.find(b"\xc0", i)
            if j < 0:
                buf += data[i:]
                # an oversized open frame is dropped at the closing FEND
                # anyway (src/kiss.rs:211-217); bound the memory now
                if len(buf) > self.max_len:
                    buf = buf[: self.max_len + 1]
                break
            frame = buf + data[i:j]
            buf = b""
            i = j + 1
            if frame and len(frame) <= self.max_len:
                out.append(Pdu(np.frombuffer(frame, np.uint8)))
        return {"synced": synced, "buf": buf}, out

    def apply(self, x):
        _, out = self.apply_chunk(self.init_state(), x)
        return out


class KissDecode(Block):
    """KISS frame -> packet PDU (reference src/kiss.rs unescape())."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def apply(self, pdus):
        out = []
        for p in pdus:
            data = _host_bytes(p.data)
            nz = np.flatnonzero(data != KISS_FEND)
            if nz.size == 0:
                continue
            body = data[nz[0] : nz[-1] + 1]
            port, body = int(body[0]), body[1:]
            if port & 0xF != 0:
                continue  # non-data packet
            un, esc, bad = [], False, False
            for v in body.tolist():
                if esc:
                    if v == KISS_TFESC:
                        un.append(KISS_FESC)
                    elif v == KISS_TFEND:
                        un.append(KISS_FEND)
                    else:
                        bad = True
                        break
                    esc = False
                elif v == KISS_FESC:
                    esc = True
                elif v == KISS_FEND:
                    bad = True
                    break
                else:
                    un.append(v)
            if bad or esc:
                continue
            out.append(
                Pdu(
                    np.asarray(un, np.uint8),
                    p.tags
                    + [
                        Tag(0, "KissDecode:port", port >> 4),
                        # parity with reference src/kiss.rs:120-133
                        Tag(0, "KissDecode:input-bytes", len(body)),
                        Tag(0, "KissDecode:output-bytes", len(un)),
                    ],
                )
            )
        return out


class Il2pDeframer(Block):
    """IL2P header deframer (reference src/il2p_deframer.rs): consumes a bit
    stream, emits one empty PDU per parsed header, tagged ``il2p:src``,
    ``il2p:dst`` and ``il2p:type`` (the reference also delivers only
    headers).  ``decoded`` and ``headers`` count and keep what it found.

    Streaming state: the last ``len(SYNC_WORD) - 1 + HEADER_BITS`` (143)
    input bits, a uint8 tensor.  A sync word whose header is not complete
    at the end of a chunk lies wholly in that tail, so the next chunk finds
    it; one whose header is complete starts before the tail, so no header
    is found twice: the streamed output is the offline one.  The JAX
    package's block keeps no state and loses a header across a seam."""

    graph_capturable = False  # host: bits read back
    domain = "host"
    _TAIL = len(SYNC_WORD) - 1 + HEADER_BITS

    def __init__(self):
        self.decoded = 0
        self.headers = []

    def _emit(self, bits):
        hdrs = il2p_deframe(bits)
        self.decoded += len(hdrs)
        self.headers.extend(hdrs)
        return [Pdu(np.zeros(0, np.uint8),
                    [Tag(0, "il2p:src", h.src), Tag(0, "il2p:dst", h.dst),
                     Tag(0, "il2p:type", h.describe())]) for h in hdrs]

    def apply(self, x):
        return self._emit(_host_bytes(x))

    def init_state(self):
        return torch.zeros(0, dtype=torch.uint8)

    def apply_chunk(self, state, x):
        # None: a JAX package's state (its block carries none)
        prev = np.zeros(0, np.uint8) if state is None else _host_bytes(state)
        ext = np.concatenate([prev, _host_bytes(x)])
        tail = torch.from_numpy(ext[max(len(ext) - self._TAIL, 0):].copy())
        return tail, self._emit(ext)


class Fft(Block):
    """FFT per PDU (reference src/fft.rs), on the PDU's device: a tensor
    PDU stays where it is, a numpy one goes to ``device`` (which it then
    needs)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def __init__(self, size: int | None = None, window=None, shift: bool = False,
                 device=None):
        self.size, self.window, self.shift = size, window, shift
        self.device = device

    def apply(self, pdus):
        out = []
        for p in pdus:
            if self.size is not None and len(p.data) != self.size:
                raise ValueError(f"FFT expected {self.size} samples, got {len(p.data)}")
            out.append(Pdu(fft_pdu(p.data, self.window, self.shift,
                                   device=None if torch.is_tensor(p.data)
                                   else self.device), p.tags))
        return out


class FftStream(Block):
    """Streaming framed FFT (reference src/fft_stream.rs); carries the
    samples short of a whole frame."""

    graph_capturable = True

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("FFT size must be nonzero")
        self.size = size

    def apply(self, x):
        out, _, _ = fft_stream(x, self.size)
        return out

    def init_state(self):
        return torch.zeros(0, dtype=torch.complex64)

    def apply_chunk(self, state, x):
        ext = torch.cat([state.to(x.device), x.to(torch.complex64)])
        out, _, leftover = fft_stream(ext, self.size)
        return leftover.clone(), out


class PduWriter(Block):
    """Write each PDU to a file named by receive time
    (reference src/pdu_writer.rs)."""

    graph_capturable = False  # host: PDUs
    n_out = 0
    domain = "host"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._count = 0

    def apply(self, pdus):
        for p in pdus:
            name = f"{time.strftime('%Y-%m-%dT%H:%M:%S')}.{self._count:06d}"
            with open(os.path.join(self.directory, name), "wb") as f:
                f.write(_host_bytes(p.data).tobytes())
            self._count += 1
        return ()


MORSE_TABLE = {
    **{
        chr(ord("a") + i): code
        for i, code in enumerate(
            [".-", "-...", "-.-.", "-..", ".", "..-.", "--.", "....", "..",
             ".---", "-.-", ".-..", "--", "-.", "---", ".--.", "--.-", ".-.",
             "...", "-", "..-", "...-", ".--", "-..-", "-.--", "--.."]
        )
    },
    **{
        str(d): code
        for d, code in enumerate(
            ["-----", ".----", "..---", "...--", "....-", ".....", "-....",
             "--...", "---..", "----."]
        )
    },
}


def morse_encode_bits(msg: str) -> np.ndarray:
    """String -> on/off keying bits (reference src/morse_encode.rs:32-79)."""
    out: list[int] = []
    chars = list(msg)
    for i, c in enumerate(chars):
        lc = c.lower()
        if lc in MORSE_TABLE:
            for sym in MORSE_TABLE[lc]:
                out.extend([1, 0] if sym == "." else [1, 1, 1, 0])
            nxt = chars[i + 1] if i + 1 < len(chars) else None
            if nxt is not None and nxt != " ":
                out.extend([0, 0])
        elif c == " ":
            out.extend([0, 0, 0, 0, 0, 0])
    out.extend([0, 0, 0, 0, 0, 0])
    return np.asarray(out, np.uint8)


class MorseEncode(Block):
    """String PDUs -> on/off keying PDUs (reference src/morse_encode.rs)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def apply(self, pdus):
        return [Pdu(morse_encode_bits(str(p.data)), p.tags) for p in pdus]


class Hasher(Block):
    """SHA-512 of the whole stream -> ONE PDU at end of stream
    (reference src/hasher.rs: the digest is pushed on EOF/Drop, :41-49).

    ``apply``/``apply_chunk`` only accumulate; the digest PDU comes from
    ``flush()`` in the graph's end-of-stream drain."""

    graph_capturable = False  # host: hashes the bytes on the host
    domain = "host"

    def __init__(self, kind: str = "sha512"):
        self._h = hashlib.new(kind)
        self._done = False

    def apply(self, x):
        self._h.update(_host_bytes(x).tobytes())
        return []

    def flush(self):
        if self._done:  # idempotent, like the reference's `done` guard
            return None
        self._done = True
        return [Pdu(np.frombuffer(self._h.digest(), np.uint8))]

    def hexdigest(self) -> str:
        return self._h.hexdigest()


class ToText(Block):
    """Streams -> text lines, one per sample, the streams' values side by
    side (reference src/to_text.rs): a host uint8 tensor of the text."""

    graph_capturable = False  # host: formats numbers
    domain = "host"

    def __init__(self, n_in: int = 1):
        self.n_in = n_in

    def apply(self, *xs):
        arrs = [x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                for x in xs]
        lines = [" ".join(str(v) for v in row) for row in zip(*arrs)]
        text = ("\n".join(lines) + "\n") if lines else ""
        return torch.from_numpy(np.frombuffer(text.encode(), np.uint8).copy())


class Canary(Block):
    """Runs a lambda when the stream ends (reference src/canary.rs): the
    runners call ``finish()`` at the end of every run."""

    graph_capturable = False  # host: a lambda at the end
    domain = "host"

    def __init__(self, fn):
        self.fn = fn

    def apply(self, x):
        return x

    def finish(self):
        self.fn()
