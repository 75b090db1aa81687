"""FIR tap generators (host-side numpy, computed once at graph build).

A copy of ``rustradio_tpu/taps.py``, not an import of it: importing any
``rustradio_tpu`` submodule runs that package's ``__init__``, which
imports jax.

Numerically equivalent to the reference's generators:
* ``low_pass`` — windowed sinc, DC-gain normalized (src/fir.rs:614-650)
* ``low_pass_complex`` — same taps as complex (src/fir.rs:591-601)
* ``compute_ntaps`` — attenuation-based length (src/fir.rs:603-607)
* ``hilbert`` — odd antisymmetric 1/n taps (src/fir.rs:654-674)
* ``band_pass`` — difference of two windowed sincs (no reference
  counterpart; the AFSK front-end's input filter)
* ``multiband`` — IFFT of an ideal multiband response (src/fir.rs:554-587)

All math is done in float32 like the reference's ``Float``.
"""

from __future__ import annotations

import numpy as np

from .windows import make_window, max_attenuation


def compute_ntaps(samp_rate: float, twidth: float, window: str = "hamming") -> int:
    """Number of taps for given transition width (src/fir.rs:603-607)."""
    a = max_attenuation(window)
    t = int(a * samp_rate / (22.0 * twidth))
    return t + 1 if t % 2 == 0 else t


def low_pass(
    samp_rate: float,
    cutoff: float,
    twidth: float,
    window: str = "hamming",
) -> np.ndarray:
    """Windowed-sinc low-pass taps, unity DC gain (src/fir.rs:614-650)."""
    ntaps = compute_ntaps(samp_rate, twidth, window)
    win = make_window(window, ntaps).astype(np.float32)
    m = (ntaps - 1) // 2
    fwt0 = np.float32(2.0 * np.float32(np.pi) * np.float32(cutoff) / np.float32(samp_rate))
    n = np.arange(ntaps, dtype=np.int64) - m
    nf = n.astype(np.float32)
    pi = np.float32(np.pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        taps = np.where(
            n == 0,
            fwt0 / pi * win,
            np.sin(nf * fwt0) / (nf * pi) * win,
        ).astype(np.float32)
    # Normalize DC gain exactly like the reference: fmax = taps[m] + 2*sum tail
    fmax = np.float32(taps[m])
    for k in range(1, m + 1):
        fmax += np.float32(2.0) * taps[k + m]
    return (taps * (np.float32(1.0) / fmax)).astype(np.float32)


def low_pass_complex(
    samp_rate: float, cutoff: float, twidth: float, window: str = "hamming"
) -> np.ndarray:
    """Low-pass taps as complex64 (src/fir.rs:591-601)."""
    return low_pass(samp_rate, cutoff, twidth, window).astype(np.complex64)


def band_pass(
    samp_rate: float, low: float, high: float, ntaps: int = 65,
    window: str = "hamming",
) -> np.ndarray:
    """Windowed-sinc band-pass taps (difference of two low-passes), unity
    passband-center gain.

    No reference counterpart (rustradio designs only low-pass/hilbert/
    multiband); used by the AFSK front-end to band-limit noise BEFORE the
    phase discriminator.
    """
    if not 0.0 < low < high < samp_rate / 2:
        raise ValueError("need 0 < low < high < samp_rate/2")
    n = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0

    def lp(fc):
        return np.sinc(2.0 * fc / samp_rate * n) * (2.0 * fc / samp_rate)

    h = (lp(high) - lp(low)) * make_window(window, ntaps)
    # normalize gain at the passband centre
    fc = (low + high) / 2.0
    g = np.abs(np.sum(h * np.exp(-2j * np.pi * fc / samp_rate * np.arange(ntaps))))
    return (h / g).astype(np.float32)


def hilbert(ntaps: int, window: str = "hamming") -> np.ndarray:
    """Hilbert transformer taps (src/fir.rs:654-674).

    Antisymmetric, odd length; even-index taps zero; normalized by the
    alternating-sum gain exactly like the reference.
    """
    if ntaps % 2 != 1:
        raise ValueError("hilbert filter length must be odd")
    win = make_window(window, ntaps).astype(np.float32)
    mid = (ntaps - 1) // 2
    taps = np.zeros(ntaps, np.float32)
    gain = np.float32(0.0)
    for i in range(1, mid + 1):
        if i % 2 == 1:
            x = np.float32(1.0) / np.float32(i)
            taps[mid + i] = x * win[mid + i]
            taps[mid - i] = -x * win[mid - i]
            gain = taps[mid + i] - gain
    gain = np.float32(1.0) / (np.float32(2.0) * np.abs(gain))
    return (taps * gain).astype(np.float32)


def multiband(
    bands: list[tuple[float, float]], ntaps: int, window: np.ndarray
) -> np.ndarray:
    """Multiband filter taps via IFFT of an ideal response (src/fir.rs:554-587).

    ``bands`` are (low, high) in normalized [0, 1] frequency.  Returns
    complex64 taps of length ``ntaps``.
    """
    if ntaps == 0 or ntaps != len(window):
        raise ValueError("taps must be nonzero and match window length")
    ideal = np.zeros(ntaps, np.complex64)
    scale = np.float32(ntaps) / 2.0
    for low, high in bands:
        a = int(np.floor(low * scale))
        b = int(np.ceil(high * scale))
        if a > ntaps or b > ntaps:
            raise ValueError("band out of range")
        for n in range(a, b):
            ideal[n] = 1.0
            ideal[ntaps - n - 1] = 1.0
    # The reference uses rustfft's unnormalized inverse FFT, then rotates
    # right by ntaps//2 and divides by sqrt(ntaps).
    t = np.fft.ifft(ideal) * ntaps  # unnormalized inverse
    t = np.roll(t, ntaps // 2)
    t = t / np.sqrt(np.float32(ntaps))
    return (t * window).astype(np.complex64)
