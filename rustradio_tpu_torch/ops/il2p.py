"""IL2P deframing (numpy copy of ``rustradio_tpu/ops/il2p.py``; reference
src/il2p_deframer.rs).

Sync word 0xF15E48 hunted via the access-code correlator; the 15-byte
(120-bit) header is descrambled with the IL2P LFSR (mask 0x108, seed
0x1F0), packed MSB-first, its 2 RS-FEC bytes stripped (the reference does
not implement RS decoding either, src/il2p_deframer.rs:209-210), and the
scattered header fields extracted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .correlate import correlate_access_code

SYNC_WORD = np.asarray(
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0],
    np.uint8,
)
HEADER_BITS = 15 * 8


def il2p_descramble(bits: np.ndarray, mask: int = 0x108, seed: int = 0x1F0) -> np.ndarray:
    """IL2P LFSR (reference src/il2p_deframer.rs:107-128).

    ret = 1 & (i ^ reg); reg = (reg >> 1) ^ (mask * i).
    """
    reg = seed
    out = np.empty(len(bits), np.uint8)
    for n, i in enumerate(np.asarray(bits, np.uint8)):
        i = int(i) & 1
        out[n] = 1 & (i ^ reg)
        reg = (reg >> 1) ^ (mask * i)
    return out


def _bits_to_bytes_msb(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


def decode_callsign(data: np.ndarray) -> str:
    """SIXBIT callsign decode (reference src/il2p_deframer.rs:265-274)."""
    chars = [(int(c) & 63) for c in data]
    return "".join(chr(c + 0x20) for c in chars if c > 0)


@dataclasses.dataclass
class Il2pHeader:
    dst: str
    src: str
    ui: bool
    fec: bool
    pid: int
    control: int
    hdrtype1: bool
    payload_size: int

    def describe(self) -> str:
        if not self.hdrtype1:
            return "type0 IL2P"
        if self.ui:
            return "UI"
        if self.pid == 1:  # AX25_UNNUMBERED
            names = [
                "invalid 0x00", "SABM", "invalid 0x02", "DISC", "DM",
                "invalid 0x05", "UA", "invalid 0x07", "FRMR", "unvalid 0x09",
                "UI unnumbered response", "UI unnumbered command",
                "XID response", "XID command", "TEST response", "TEST command",
            ]
            return names[(self.control >> 2) & 0xF]
        return "other PID"


def parse_header(data: np.ndarray) -> Il2pHeader:
    """Parse the 13 descrambled header bytes
    (reference src/il2p_deframer.rs:289-319)."""
    d = [int(b) for b in np.asarray(data, np.uint8)]
    if len(d) != 13:
        raise ValueError(f"IL2P header must be 13 bytes, got {len(d)}")
    pid = (
        ((d[1] & 0x40) >> 3) | ((d[2] & 0x40) >> 4)
        | ((d[3] & 0x40) >> 5) | ((d[4] & 0x40) >> 6)
    )
    control = (
        (d[5] & 0x40) | ((d[6] & 0x40) >> 1) | ((d[7] & 0x40) >> 2)
        | ((d[8] & 0x40) >> 3) | ((d[9] & 0x40) >> 4)
        | ((d[10] & 0x40) >> 5) | ((d[11] & 0x40) >> 6)
    )
    payload_size = (
        ((d[2] & 0x80) << 2) | ((d[3] & 0x80) << 1) | (d[4] & 0x80)
        | ((d[5] & 0x80) >> 1) | ((d[6] & 0x80) >> 2) | ((d[7] & 0x80) >> 3)
        | ((d[8] & 0x80) >> 4) | ((d[9] & 0x80) >> 5)
        | ((d[10] & 0x80) >> 6) | ((d[11] & 0x80) >> 7)
    )
    return Il2pHeader(
        dst=f"{decode_callsign(d[0:6])}-{d[12] >> 4}",
        src=f"{decode_callsign(d[6:12])}-{d[12] & 0xF}",
        ui=(d[0] & 0x40) != 0,
        fec=(d[0] & 0x80) != 0,
        pid=pid,
        control=control,
        hdrtype1=(d[1] & 0x80) != 0,
        payload_size=payload_size,
    )


def il2p_deframe(bits) -> list[Il2pHeader]:
    """Find sync words in a bit stream (u8 numpy array or tensor) and parse
    each following header; a sync word whose header runs past the end of
    ``bits`` is skipped."""
    if torch.is_tensor(bits):
        bits = bits.detach().cpu().numpy()
    bits = np.asarray(bits, np.uint8)
    match = correlate_access_code(torch.from_numpy(bits), SYNC_WORD, 0).numpy()
    headers = []
    for pos in np.flatnonzero(match):
        start = pos + 1
        if start + HEADER_BITS > len(bits):
            continue
        raw = bits[start : start + HEADER_BITS]
        hdr_bytes = _bits_to_bytes_msb(il2p_descramble(raw))
        try:
            headers.append(parse_header(hdr_bytes[:-2]))
        except ValueError:
            continue
    return headers
