"""Parsing helpers of the CLI apps (the ``parse_frequency`` part of
``rustradio_tpu/dtypes.py``, which imports jax)."""

from __future__ import annotations


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
