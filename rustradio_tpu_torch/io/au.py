"""Sun .au audio format (numpy copy of ``rustradio_tpu/io/au.py``;
reference src/au.rs).

Streamable format: 28-byte big-endian header, PCM16 data.  The reference's
AuDecode accepts only PCM16 mono and converts i16/32767 -> f32
(src/au.rs:255-281); AuEncode writes header with unknown size then i16 BE
samples scaled by 32767 (src/au.rs:116-154).
"""

from __future__ import annotations

import struct

import numpy as np

AU_MAGIC = 0x2E736E64  # ".snd"
ENCODING_PCM16 = 3


def au_decode(data: bytes, expected_rate: int | None = None):
    """Decode .au bytes -> (float32 samples, sample_rate).

    Only PCM16 mono is supported, like the reference (src/au.rs:236-251).
    """
    if len(data) < 24:
        raise ValueError("AU header is too short")
    magic, data_offset, _size, encoding, rate, channels = struct.unpack(
        ">IIIIII", data[:24]
    )
    if magic != AU_MAGIC:
        raise ValueError(".au magic value not found")
    if data_offset < 8:
        raise ValueError("AU data offset smaller than fixed header")
    if encoding != ENCODING_PCM16:
        raise ValueError("only PCM16 encoding supported")
    if channels != 1:
        raise ValueError(f"AU block only supports one channel currently, got {channels}")
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(f"AU expected bitrate {expected_rate}, got {rate}")
    payload = data[data_offset:]
    n = len(payload) // 2
    pcm = np.frombuffer(payload[: n * 2], dtype=">i2").astype(np.float32)
    return pcm / np.float32(32767.0), rate


def au_encode(samples, rate: int) -> bytes:
    """Encode float32 samples in [-1, 1] as PCM16 mono .au bytes."""
    samples = np.asarray(samples, np.float32)
    header = struct.pack(
        ">IIIIII4x", AU_MAGIC, 28, 0xFFFFFFFF, ENCODING_PCM16, rate, 1
    )
    # The reference casts (f * 32767) to i16 (truncation toward zero),
    # src/au.rs:147-149.
    pcm = np.trunc(samples * np.float32(32767.0)).clip(-32768, 32767).astype(">i2")
    return header + pcm.tobytes()


def au_read(path: str, expected_rate: int | None = None):
    with open(path, "rb") as f:
        return au_decode(f.read(), expected_rate)
