"""CMA blind equalizer (port of ``rustradio_tpu/ops/cma.py``; reference
src/cma.rs, "WIP, completely untested" there: the same update rule).

Per output sample (src/cma.rs:66-84):
    y[i]   = sum_k taps[k] * x[i + k]
    e      = R - |y|^2
    taps  += mu * e * y * conj(window)

An adaptive recurrence: each window needs the taps the window before it
left.  The JAX package runs it as a ``lax.scan``; here it is kernel F
(``kernels.cma_scan``) on the card and its plain version on the CPU, both
in the delayed-update form (the same function rounded in another order,
within 1e-5 of max|y| of float64 and of the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fft import as_stream


def cma_equalize(x, ntaps: int, desired_modulus: float = 1.0,
                 step_size: float = 1e-3, taps=None, device=None):
    """Returns ``(y, final_taps)``, complex64 on ``x``'s device; y has
    len(x) - ntaps + 1 samples.  ``taps`` (ntaps complex values) start the
    recurrence; by default 1 at index 0 and 0 elsewhere.  ``x`` is a
    tensor, or a numpy array with ``device=``."""
    if ntaps == 0:
        raise ValueError("ntaps must be nonzero")
    x = as_stream(x, device, "cma_equalize").contiguous()
    if x.shape[0] < ntaps:
        raise ValueError(f"input {x.shape[0]} shorter than taps {ntaps}")
    if taps is None:
        t0 = torch.zeros(ntaps, dtype=torch.complex64, device=x.device)
        t0[0] = 1.0
    else:
        t0 = (taps.to(x.device) if torch.is_tensor(taps) else torch.from_numpy(
            np.asarray(taps, np.complex64)).to(x.device)).to(torch.complex64)
        if t0.shape != (ntaps,):
            raise ValueError(f"taps of shape {tuple(t0.shape)}, want ({ntaps},)")
    return kernels.cma_scan(x, t0.contiguous(), desired_modulus, step_size)
