"""Raw sample files (numpy copy of ``rustradio_tpu/io/rawfile.py``;
reference src/file_source.rs / src/file_sink.rs).

Samples are stored little-endian: c64 as interleaved f32 IQ pairs, matching
the reference's Sample serialization (src/lib.rs:680-800).
"""

from __future__ import annotations

import numpy as np

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
