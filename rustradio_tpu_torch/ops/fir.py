"""FIR filtering (port of ``rustradio_tpu/ops/fir.py``).

Reference semantics (src/fir.rs):

* ``fir_filter`` — the reference FirFilter's "valid" alignment,
  ``y[m] = sum_j taps[j] * x[m*deci + ntaps-1 - j]``, output length
  ``(N - ntaps)//deci + 1`` (src/fir.rs:166-194, work():489-547).
* ``fir_filter_full`` — the zero-history full convolution of the
  reference FftFilter, ``y[m] = sum_j taps[j] * x[m*deci - j]``, output
  length ``ceil(N/deci)`` (src/fft_filter.rs:289-354).

Both run on ``kernels.fir_decimate`` (kernel A on the card, its plain
version on the CPU), up to ``kernels.MAX_TAPS`` taps.  The FFT path for
longer filters and ``fir_filter_translating`` come in a later slice.
"""

from __future__ import annotations

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
