"""Raw sample files and the rtl-sdr u8 wire format (numpy copy of
``rustradio_tpu/io/rawfile.py``;
reference src/file_source.rs / src/file_sink.rs).

Samples are stored little-endian: c64 as interleaved f32 IQ pairs, matching
the reference's Sample serialization (src/lib.rs:680-800).
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "c32": np.complex64,
    "f32": np.float32,
    "u8": np.uint8,
    "i32": np.int32,
    "u32": np.uint32,
}


def _resolve(dtype):
    if isinstance(dtype, str):
        return np.dtype(_DTYPES.get(dtype, dtype))
    return np.dtype(dtype)


def read_samples(path: str, dtype="c32", repeat: int = 1) -> np.ndarray:
    dt = _resolve(dtype).newbyteorder("<")
    data = np.fromfile(path, dtype=dt)
    if repeat > 1:
        data = np.tile(data, repeat)
    return data


def write_samples(path: str, samples, dtype=None, mode: str = "wb") -> None:
    arr = np.asarray(samples)
    if dtype is not None:
        arr = arr.astype(_resolve(dtype))
    arr = arr.astype(arr.dtype.newbyteorder("<"))
    with open(path, mode) as f:
        arr.tofile(f)


def rtlsdr_decode(raw):
    """u8 offset-127 IQ -> complex64, scale 0.008 (src/rtlsdr_decode.rs):
    a numpy array on the host, a tensor on its device (the same f32
    values: (v - 127) * 0.008 on each plane)."""
    if torch.is_tensor(raw):
        iq = (raw.to(torch.float32) - 127.0).view(-1, 2)
        return torch.complex(iq[:, 0] * 0.008, iq[:, 1] * 0.008)
    raw = np.asarray(raw, np.uint8).astype(np.float32) - 127.0
    iq = raw.reshape(-1, 2)
    return ((iq[:, 0] + 1j * iq[:, 1]) * 0.008).astype(np.complex64)


def rtlsdr_encode(samples):
    """complex64 -> u8 offset-127 IQ (src/rtlsdr_encode.rs): each plane /
    0.008 + 127, rounded half to even, clipped to 0..255; a numpy array on
    the host, a tensor on its device."""
    if torch.is_tensor(samples):
        planes = torch.view_as_real(samples.to(torch.complex64)) / 0.008
        return torch.clamp(torch.round(planes.reshape(-1) + 127.0), 0, 255
                           ).to(torch.uint8)
    s = np.asarray(samples, np.complex64) / 0.008
    out = np.empty(2 * len(s), np.uint8)
    out[0::2] = np.clip(np.round(s.real + 127.0), 0, 255).astype(np.uint8)
    out[1::2] = np.clip(np.round(s.imag + 127.0), 0, 255).astype(np.uint8)
    return out
