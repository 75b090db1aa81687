"""AX.25 framing as a transmitter makes it, in NumPy: the CRC-16/X.25
frame check sequence, HDLC flags and bit stuffing (LSB first), and the
NRZI line that Bell 202 keys (a transition for a 0).

A frozen copy of rustradio's ``src/hdlc_framer.rs`` and
``src/hdlc_deframer.rs`` CRC, kept with the benchmark so that no change
to the program moves what the transmitter sends or what the check
expects.
"""

from __future__ import annotations

import numpy as np

FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)  # 0x7E, LSB first


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint16)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x8408 if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _crc_table()


def crc16_x25(data: bytes) -> int:
    """CRC-16/X.25 (reflected 0x1021, init and final xor 0xFFFF)."""
    fcs = 0xFFFF
    for byte in data:
        fcs = (fcs >> 8) ^ int(_TABLE[(fcs ^ byte) & 0xFF])
    return fcs ^ 0xFFFF


def fcs_add(data: bytes) -> bytes:
    """The frame with its FCS appended, low byte first."""
    crc = crc16_x25(data)
    return bytes(data) + bytes([crc & 0xFF, crc >> 8])


def stuff(bits: np.ndarray) -> np.ndarray:
    """A 0 inserted after every run of five 1s."""
    out = []
    ones = 0
    for b in bits.tolist():
        out.append(b)
        ones = ones + 1 if b else 0
        if ones == 5:
            out.append(0)
            ones = 0
    return np.asarray(out, np.uint8)


def hdlc_frame(data: bytes, sync_flags: int = 20) -> np.ndarray:
    """Payload -> the bits on the line before NRZI: ``sync_flags`` flags,
    the stuffed payload and FCS, ``sync_flags`` flags."""
    bits = np.unpackbits(np.frombuffer(fcs_add(data), np.uint8),
                         bitorder="little")
    flags = np.tile(FLAG, sync_flags)
    return np.concatenate([flags, stuff(bits), flags])


def nrzi_line(framed: np.ndarray) -> np.ndarray:
    """NRZI: the line level toggles on a 0 and holds on a 1; starts at 1."""
    return ((1 + np.cumsum(1 - framed.astype(np.int64))) % 2).astype(np.uint8)
