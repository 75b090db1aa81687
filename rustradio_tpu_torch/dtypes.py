"""Sample types and the parsing helpers of the CLI apps (port of
``rustradio_tpu/dtypes.py``, which imports jax).

The reference fixes ``Float = f32`` and ``Complex = Complex<f32>``
(src/lib.rs:245-249); here they are torch dtypes.  The JAX package's
``stage_iq`` / ``read_iq`` exist only for a TPU transport that cannot move
complex64 and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

# Stream sample dtypes (reference src/lib.rs:245-249: Float=f32, Complex=c64).
Float = torch.float32
Complex = torch.complex64
U8 = torch.uint8
I16 = torch.int16
I32 = torch.int32
U32 = torch.uint32
U64 = torch.uint64
Bit = torch.uint8  # bits travel as u8 0/1, like the reference's ReadStream<u8>

# numpy mirrors for host-side code
NP_FLOAT = np.float32
NP_COMPLEX = np.complex64

#: Default streaming chunk size in samples.  The reference sizes its circular
#: buffers at 4_096_000 bytes (src/stream.rs:105); here fixed-size chunks of
#: samples.  2**20 complex64 samples = 8 MiB.
DEFAULT_CHUNK_SIZE = 1 << 20


def parse_frequency(s: str) -> float:
    """Parse ``100k`` / ``2M`` / ``2.4g`` style frequencies.

    Mirrors reference src/lib.rs:655-678: optional k/m/g suffix
    (case-insensitive), underscores stripped.
    """
    s = s.replace("_", "")
    if not s:
        raise ValueError("empty string is not a frequency")
    mul = 1.0
    last = s[-1].lower()
    if last in ("k", "m", "g") and len(s) > 1:
        mul = {"k": 1e3, "m": 1e6, "g": 1e9}[last]
        s = s[:-1]
    try:
        return float(s) * mul
    except ValueError as e:
        raise ValueError(
            f"Invalid number {s!r}: {e}. Has to be a float with optional k/m/g suffix"
        ) from e


def parse_verbosity(s: str) -> int:
    """Parse log-level names to a verbosity int (src/lib.rs:624-629)."""
    levels = {"error": 0, "warn": 1, "info": 2, "debug": 3, "trace": 4}
    try:
        return levels[s.lower()]
    except KeyError:
        raise ValueError(
            f"{s!r}: valid values are: error, warn, info, debug, trace"
        ) from None
