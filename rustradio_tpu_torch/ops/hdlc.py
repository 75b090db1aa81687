"""HDLC framing/deframing and CRC-16/X.25 (port of
``rustradio_tpu/ops/hdlc.py``; host-side numpy).

Deframer semantics (reference src/hdlc_deframer.rs:123-231): hunt for the
0x7E flag, collect bits, drop the stuffed 0 after five 1s, abort on seven
1s, strip the trailing partial flag (7 bits), require a byte multiple and
min/max size, check CRC-16/X.25 (little-endian trailer), optionally repair
a single flipped bit (find_right_crc :41-71).  ``hdlc_deframe`` runs the
native C++ deframer (``native.HdlcDeframer``) and raises when the library
cannot be built; the Python ``HdlcStateMachine`` is its reference and
decodes the same packets.

The CRC table is RFC1662's, generated here rather than pasted (reference
src/hdlc_deframer.rs:274-315 uses the table form).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.trace import span

#: decoded / crc_error / bitfixed over every ``hdlc_deframe`` call of the
#: process, the reference's drop-time log (src/hdlc_deframer.rs:103-110):
#: read as differences around a call, as ``apps/ax25_1200_rx.py``'s closing
#: line does
TOTALS = {"decoded": 0, "crc_error": 0, "bitfixed": 0}


def _make_crc_table() -> np.ndarray:
    # CRC-16/X.25: reflected polynomial 0x8408 (RFC1662 FCS table).
    table = np.zeros(256, np.uint16)
    for b in range(256):
        v = b
        for _ in range(8):
            v = (v >> 1) ^ 0x8408 if (v & 1) else v >> 1
        table[b] = v
    return table


_CRC_TABLE = _make_crc_table()


def _host_bits(bits) -> np.ndarray:
    if torch.is_tensor(bits):
        bits = bits.cpu().numpy()
    return np.asarray(bits, np.uint8)


def calc_crc(data) -> int:
    """CRC-16/X.25 over bytes (reference src/hdlc_deframer.rs:307-315)."""
    fcs = np.uint16(0xFFFF)
    for byte in np.asarray(data, np.uint8):
        fcs = np.uint16(fcs >> 8) ^ _CRC_TABLE[(fcs ^ byte) & 0xFF]
    return int(fcs ^ 0xFFFF)


def calc_crc_batch(data: np.ndarray) -> np.ndarray:
    """Vectorized CRC over a batch of equal-length byte rows."""
    data = np.asarray(data, np.uint8)
    fcs = np.full(data.shape[0], 0xFFFF, np.uint16)
    for j in range(data.shape[1]):
        fcs = (fcs >> 8) ^ _CRC_TABLE[(fcs ^ data[:, j]) & 0xFF]
    return fcs ^ np.uint16(0xFFFF)


def _bits_to_bytes_lsb(bits: np.ndarray) -> np.ndarray:
    """8 bits LSB-first per byte (reference bits2byte, :262-272)."""
    b = bits.reshape(-1, 8)
    return (b * (1 << np.arange(8, dtype=np.uint16))).sum(axis=1).astype(np.uint8)


def _find_right_crc(data: np.ndarray, got: int, fix_bits: bool):
    """Single-bitflip CRC repair (reference src/hdlc_deframer.rs:41-71).

    Returns (maybe_fixed_data, crc, fixed?).
    """
    crc = calc_crc(data)
    if got == crc or not fix_bits:
        return None, crc, False
    n = len(data)
    if n:
        # every single-bit flip of the payload at once: n*8 copies
        batch = np.repeat(data[None, :], n * 8, axis=0)
        rows = np.arange(n * 8)
        batch[rows, rows // 8] ^= (1 << (rows % 8)).astype(np.uint8)
        hits = np.flatnonzero(calc_crc_batch(batch) == got)
        if hits.size:
            return batch[hits[0]], got, True
    for crcbit in range(16):
        if (got ^ (1 << crcbit)) == crc:
            return None, crc, True
    return None, crc, False


class HdlcStateMachine:
    """Resumable HDLC deframer state machine (reference
    src/hdlc_deframer.rs:123-231).  ``feed(bits)`` may be called repeatedly
    with consecutive chunks; frames spanning chunk boundaries decode once.
    """

    def __init__(self, min_size: int = 1, max_size: int = 1500,
                 keep_checksum: bool = False, fix_bits: bool = False):
        self.min_size, self.max_size = min_size, max_size
        self.keep_checksum, self.fix_bits = keep_checksum, fix_bits
        self.stats = {"decoded": 0, "crc_error": 0, "bitfixed": 0}
        self.state = "unsynced"
        self.shift = 0xFF
        self.ones = 0
        self.cur: list[int] = []
        self.stream_pos = 0

    def _finish(self, packets, pos: int) -> None:
        nbits = len(self.cur) - 7  # strip partial flag
        if nbits < 0:
            return
        b = np.asarray(self.cur[:nbits], np.uint8)
        if nbits % 8 != 0 or nbits // 8 < self.min_size:
            return
        by = _bits_to_bytes_lsb(b)
        if self.keep_checksum:
            self.stats["decoded"] += 1
            packets.append((by, pos))
            return
        if len(by) < 2:
            return
        data, got = by[:-2], int(by[-2]) | (int(by[-1]) << 8)
        nd, crc, fixed = _find_right_crc(data, got, self.fix_bits)
        if fixed:
            self.stats["bitfixed"] += 1
        if nd is not None:
            data = nd
        if crc != got:
            self.stats["crc_error"] += 1
            return
        self.stats["decoded"] += 1
        packets.append((data, pos))

    def _unsync(self) -> None:
        self.state = "unsynced"
        self.shift = 0xFF

    def feed(self, bits) -> list[tuple[np.ndarray, int]]:
        packets: list[tuple[np.ndarray, int]] = []
        for bit in _host_bits(bits).tolist():
            pos = self.stream_pos
            self.stream_pos += 1
            if self.state == "unsynced":
                self.shift = ((self.shift >> 1) | (bit << 7)) & 0xFF
                if self.shift == 0x7E:
                    self.state = "synced"
                    self.ones = 0
                    self.cur = []
            elif self.state == "synced":
                if len(self.cur) > self.max_size * 8:
                    self._unsync()
                    continue
                if bit:
                    self.cur.append(1)
                    if self.ones == 5:
                        self.state = "final"
                    else:
                        self.ones += 1
                elif self.ones == 5:
                    self.ones = 0  # stuffed bit, drop
                else:
                    self.cur.append(0)
                    self.ones = 0
            else:  # final check: 6 ones seen, this bit must be 0
                if bit == 1 or len(self.cur) < 7:
                    self._unsync()
                    continue
                self._finish(packets, pos)
                self.state = "synced"
                self.ones = 0
                self.cur = []
        return packets

    def snapshot(self) -> dict:
        """The machine's whole condition as host values (the JAX package's
        keys, ``rustradio_tpu/ops/hdlc.py:179``): a checkpointable state."""
        return {
            "state": self.state, "shift": self.shift, "ones": self.ones,
            "cur": list(self.cur), "stream_pos": self.stream_pos,
            "stats": dict(self.stats),
        }

    def restore(self, snap: dict) -> None:
        """Continue from a :meth:`snapshot` (of either package)."""
        self.state = str(snap["state"])
        self.shift = int(snap["shift"])
        self.ones = int(snap["ones"])
        self.cur = [int(b) for b in snap["cur"]]
        self.stream_pos = int(snap["stream_pos"])
        self.stats = {k: int(v) for k, v in snap["stats"].items()}


def hdlc_deframe(bits, min_size: int = 1, max_size: int = 1500,
                 keep_checksum: bool = False, fix_bits: bool = False):
    """Deframe a 0/1 bit array (numpy or tensor) into packets, one shot.

    Returns (packets, stats): packets is a list of (bytes as uint8 numpy,
    stream_pos), stats counts decoded/crc_error/bitfixed like the
    reference's Drop logging (src/hdlc_deframer.rs:103-110); each call
    adds them to ``TOTALS``.
    """
    with span("hdlc.to_host"):
        host = _host_bits(bits)
    sm = native.HdlcDeframer(min_size, max_size, keep_checksum, fix_bits)
    with span("hdlc.deframe"):
        packets = sm.feed(host)
    stats = sm.stats
    for k, v in stats.items():
        TOTALS[k] += v
    return packets, stats


def hdlc_bit_hunt(bits):
    """Device-side helpers for fast deframing: flag positions + run info.

    Returns (flag_mask, ones_run) on the input's device: flag_mask[n]
    (bool) marks n as the last bit of a 0x7E flag and ones_run[n] (int64)
    is the length of the run of ones ending at n.  A compare over 8
    shifted views, and ``cummax`` for the distance to the last zero.
    """
    b = torch.as_tensor(bits).to(torch.uint8)
    n = b.shape[0]
    # flag: bits[n-7..n] == 0,1,1,1,1,1,1,0 (LSB-first window value 0x7e);
    # an unsynced shift register starts 0xff
    bp = torch.cat([b.new_ones(7), b])
    flag = torch.ones(n, dtype=torch.bool, device=b.device)
    for i, want in enumerate((0, 1, 1, 1, 1, 1, 1, 0)):
        flag &= bp[i : i + n] == want
    idx = torch.arange(n, device=b.device)
    last_zero = torch.where(b == 0, idx, torch.full_like(idx, -1))
    if n:
        last_zero = torch.cummax(last_zero, 0).values
    return flag, idx - last_zero


def hdlc_frame(data, sync_bytes: int = 20) -> np.ndarray:
    """Byte packet -> stuffed bit packet with flag runs (host side).

    Mirrors reference hdlc_encode (src/hdlc_framer.rs:61-86): ``sync_bytes``
    flags before and after, LSB-first bits, a 0 stuffed after five 1s.
    """
    flags = np.tile(np.asarray([0, 1, 1, 1, 1, 1, 1, 0], np.uint8), sync_bytes)
    bits = np.unpackbits(np.asarray(data, np.uint8)[:, None], axis=1,
                         bitorder="little").reshape(-1)
    stuffed: list[int] = []
    ones = 0
    for bit in bits.tolist():
        stuffed.append(bit)
        ones = ones + 1 if bit else 0
        if ones == 5:
            ones = 0
            stuffed.append(0)
    return np.concatenate([flags, np.asarray(stuffed, np.uint8), flags])


def fcs_add(data) -> np.ndarray:
    """Append CRC-16/X.25 little-endian (reference FcsAdder,
    src/hdlc_framer.rs:28-42)."""
    data = np.asarray(data, np.uint8)
    crc = calc_crc(data)
    return np.concatenate([data, np.asarray([crc & 0xFF, crc >> 8], np.uint8)])
