"""Hilbert transformer (port of ``rustradio_tpu/ops/hilbert.py``).

Reference semantics (src/hilbert.rs:68-125): with xp = zeros(ntaps) ++ x,

    y[i] = Complex(xp[i + ntaps//2],  sum_j taps[j] * xp[i + ntaps-1 - j])

and len(y) == len(x).  The real part is the input delayed by
ntaps - ntaps//2 samples; the imaginary part is the zero-history FIR of the
input delayed by one, y_im[i] = sum_j taps[j] x[i-1-j], which runs on
``kernels.fir_decimate`` (kernel A on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import taps as tapgen
from . import kernels


def hilbert_transform(x, ntaps: int = 65, window: str = "hamming",
                      taps=None) -> torch.Tensor:
    """Float stream -> complex64 analytic stream, reference-aligned."""
    x = torch.as_tensor(x).to(torch.float32)
    if taps is None:
        taps = tapgen.hilbert(ntaps, window)
    ntaps, n = len(taps), x.shape[0]
    y_im = kernels.fir_decimate(F.pad(x, (1, 0))[:n], taps, 1)
    y_re = F.pad(x, (ntaps - ntaps // 2, 0))[:n]
    return torch.complex(y_re, y_im)
