"""The FM channel filter, designed as rustradio designs it
(``src/fir.rs:591-650``, ``src/window.rs:64-112``): a Hamming-windowed
sinc low-pass in f32, its DC gain normalised to 1.  A frozen copy kept
with the benchmark; the configuration names the rates."""

from __future__ import annotations

import numpy as np

HAMMING_A0 = 25.0 / 46.0
HAMMING_ATTENUATION_DB = 53.0


def ntaps(samp_rate: float, twidth: float) -> int:
    t = int(HAMMING_ATTENUATION_DB * samp_rate / (22.0 * twidth))
    return t + 1 if t % 2 == 0 else t


def hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float32)
    m = np.float32(n - 1)
    return (HAMMING_A0 - (1.0 - HAMMING_A0)
            * np.cos(2.0 * np.float32(np.pi) * k / m)).astype(np.float32)


def low_pass(samp_rate: float, cutoff: float, twidth: float) -> np.ndarray:
    """The real taps of ``low_pass_complex(samp_rate, cutoff, twidth)``."""
    n = ntaps(samp_rate, twidth)
    win = hamming(n)
    m = (n - 1) // 2
    pi = np.float32(np.pi)
    fwt0 = np.float32(2.0 * pi * np.float32(cutoff) / np.float32(samp_rate))
    k = np.arange(n, dtype=np.int64) - m
    kf = k.astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        taps = np.where(k == 0, fwt0 / pi * win,
                        np.sin(kf * fwt0) / (kf * pi) * win).astype(np.float32)
    fmax = np.float32(taps[m])
    for j in range(1, m + 1):
        fmax += np.float32(2.0) * taps[j + m]
    return (taps * (np.float32(1.0) / fmax)).astype(np.float32)
