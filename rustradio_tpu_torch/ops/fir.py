"""FIR filtering (port of ``rustradio_tpu/ops/fir.py``).

Reference semantics (src/fir.rs):

* ``fir_filter`` — the reference FirFilter's "valid" alignment,
  ``y[m] = sum_j taps[j] * x[m*deci + ntaps-1 - j]``, output length
  ``(N - ntaps)//deci + 1`` (src/fir.rs:166-194, work():489-547).
* ``fir_filter_full`` — the zero-history full convolution of the
  reference FftFilter, ``y[m] = sum_j taps[j] * x[m*deci - j]``, output
  length ``ceil(N/deci)`` (src/fft_filter.rs:289-354).

* ``fir_filter_translating`` — the reference's frequency-translating FIR
  (src/fir.rs:413-483): ``fir_filter`` of the input mixed by ``-freq``.

All run on ``kernels.fir_decimate`` (kernel A on the card, its plain
version on the CPU), up to ``kernels.MAX_TAPS`` taps; complex taps over a
complex stream are real passes over the I/Q planes (two launches of two
rows each).  The FFT path for longer filters comes in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def fir_filter(x: torch.Tensor, taps, deci: int = 1) -> torch.Tensor:
    """Valid-mode decimating FIR: y[m] = sum_j taps[j] x[m*deci + ntaps-1-j]."""
    n = x.shape[0]
    ntaps = len(taps)
    if n < ntaps:
        raise ValueError(f"input {n} shorter than taps {ntaps}")
    m = (n - ntaps) // deci + 1
    # valid output m is the full conv at (ntaps-1) + m*deci; left-pad so
    # that position lands on the kernel's decimation grid
    p = (-(ntaps - 1)) % deci
    if p:
        x = torch.cat([x.new_zeros(p), x])
    y = kernels.fir_decimate(x, taps, deci)
    return y[(p + ntaps - 1) // deci :][:m]


def fir_filter_full(x: torch.Tensor, taps, deci: int = 1) -> torch.Tensor:
    """Zero-history full convolution: y[m] = sum_j taps[j] x[m*deci - j]."""
    return kernels.fir_decimate(x, taps, deci)


def fir_filter_translating(x: torch.Tensor, taps, samp_rate: float,
                           freq: float, deci: int = 1) -> torch.Tensor:
    """Frequency-translating FIR (reference src/fir.rs:413-483):
    ``fir_filter(x * exp(-2j*pi*freq/samp_rate * n), taps, deci)``.

    As the reference computes it: the taps pre-rotated by +freq, so one
    rotator per OUTPUT sample is applied (src/fir.rs:427-459, 461-470).
    Its phases are reduced mod 2*pi in float64 before the f32 cast; the
    raw phases reach |step|*deci*m, where an f32 cast would cost
    ~2^-23*|phase| radians."""
    taps = np.asarray(taps, np.complex64)
    ntaps = len(taps)
    if freq == 0.0:
        return fir_filter(x, taps, deci)
    step = 2.0 * np.pi * float(freq) / float(samp_rate)
    rot = np.exp(1j * step * np.arange(ntaps)).astype(np.complex64)
    y = fir_filter(x, (taps * rot).astype(np.complex64), deci)
    # the first output's window ends at input ntaps-1; each output advances
    # deci inputs
    m = y.shape[0]
    phases = np.mod(-step * (ntaps - 1 + deci * np.arange(m, dtype=np.float64)),
                    2.0 * np.pi).astype(np.float32)
    rotator = torch.polar(torch.ones(m), torch.from_numpy(phases))
    return y * rotator.to(y.device)
