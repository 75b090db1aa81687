"""Window functions for filter design (host-side numpy).

A copy of ``rustradio_tpu/windows.py``, not an import of it: importing any
``rustradio_tpu`` submodule runs that package's ``__init__``, which
imports jax (``rustradio_tpu/__init__.py`` -> ``dtypes.py``).  The port
must run without jax, so it carries this numpy module itself.

Numerically matches the reference's periodic windows (src/window.rs:98-185):
Hamming (default a0 = 25/46, src/window.rs:36-37), Blackman (a = 0.16),
Blackman-Harris.
"""

from __future__ import annotations

import numpy as np

DEFAULT_HAMMING_PARM = 25.0 / 46.0

#: Stop-band attenuation per window, used by ``taps.compute_ntaps``
#: (reference src/window.rs:64-75).
MAX_ATTENUATION = {
    "blackman": 74.0,
    "blackman_harris": 92.0,
    "hamming": 53.0,
}


def hamming(ntaps: int, a0: float = DEFAULT_HAMMING_PARM) -> np.ndarray:
    """Periodic Hamming window (reference src/window.rs:98-112)."""
    if ntaps == 0:
        return np.zeros(0, np.float32)
    if ntaps == 1:
        return np.ones(1, np.float32)
    a1 = 1.0 - a0
    n = np.arange(ntaps, dtype=np.float32)
    m = np.float32(ntaps - 1)
    return (a0 - a1 * np.cos(2.0 * np.float32(np.pi) * n / m)).astype(np.float32)


def blackman(m: int) -> np.ndarray:
    """Blackman window with the classic a=0.16 (reference src/window.rs:117-154)."""
    a = 0.16
    if m == 0:
        return np.zeros(0, np.float32)
    if m == 1:
        return np.ones(1, np.float32)
    n = np.arange(m, dtype=np.float32)
    mf = np.float32(m)
    a0, a1, a2 = (1.0 - a) / 2.0, 0.5, a / 2.0
    t1 = 2.0 * np.float32(np.pi) * n / mf
    t2 = 4.0 * np.float32(np.pi) * n / mf
    return (a0 - a1 * np.cos(t1) + a2 * np.cos(t2)).astype(np.float32)


def blackman_harris(m: int) -> np.ndarray:
    """Blackman-Harris window (reference src/window.rs:159-185)."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    if m == 0:
        return np.zeros(0, np.float32)
    if m == 1:
        return np.ones(1, np.float32)
    n = np.arange(m, dtype=np.float32)
    mf = np.float32(m)
    t1 = 2.0 * np.float32(np.pi) * n / mf
    t2 = 4.0 * np.float32(np.pi) * n / mf
    t3 = 6.0 * np.float32(np.pi) * n / mf
    return (a0 - a1 * np.cos(t1) + a2 * np.cos(t2) - a3 * np.cos(t3)).astype(
        np.float32
    )


_WINDOWS = {
    "hamming": hamming,
    "blackman": blackman,
    "blackman_harris": blackman_harris,
}


def make_window(window: str, ntaps: int, parm: float | None = None) -> np.ndarray:
    """Make a window by name; ``parm`` only applies to hamming."""
    key = window.lower().replace("-", "_")
    if key not in _WINDOWS:
        raise ValueError(f"unknown window {window!r}; have {sorted(_WINDOWS)}")
    if key == "hamming" and parm is not None:
        return hamming(ntaps, parm)
    return _WINDOWS[key](ntaps)


def max_attenuation(window: str) -> float:
    key = window.lower().replace("-", "_")
    try:
        return MAX_ATTENUATION[key]
    except KeyError:
        raise ValueError(f"unknown window {window!r}") from None
