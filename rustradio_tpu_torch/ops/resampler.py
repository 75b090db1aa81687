"""Rational resampler, no filtering (port of
``rustradio_tpu/ops/resampler.py``).

Reference algorithm (src/rational_resampler.rs:154-206): counter += interp
per input; emit the current sample while counter > 0, counter -= deci.
Closed form: output k comes from input floor(k*deci/interp), and N inputs
give ceil(N*interp/deci) outputs.  A pure decimation is a strided slice, a
pure interpolation a repeat, anything else one ``index_select``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _reduce(interp: int, deci: int) -> tuple[int, int]:
    g = math.gcd(interp, deci)
    return interp // g, deci // g


def resampler_indices(n: int, interp: int, deci: int) -> np.ndarray:
    """Input index of each output sample (host side)."""
    interp, deci = _reduce(interp, deci)
    m = -(-n * interp // deci)  # ceil
    return (np.arange(m, dtype=np.int64) * deci) // interp


def rational_resampler(x, interp: int, deci: int) -> torch.Tensor:
    """out[k] = x[floor(k*deci/interp)], len = ceil(N*interp/deci)."""
    interp, deci = _reduce(interp, deci)
    x = torch.as_tensor(x)
    if interp == 1 and deci == 1:
        return x
    if interp == 1:
        return x[::deci].contiguous()
    if deci == 1:
        return torch.repeat_interleave(x, interp, dim=0)
    idx = torch.from_numpy(resampler_indices(x.shape[0], interp, deci))
    return torch.index_select(x, 0, idx.to(x.device))
