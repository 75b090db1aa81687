"""Stream position ops: delay, skip, head (port of
``rustradio_tpu/ops/delay.py``).

In the reference these are scheduler-level blocks (src/delay.rs,
src/skip.rs, src/head.rs); here they are slices and a zero pad on the
stream tensor, on its device.
"""

from __future__ import annotations

import torch


def delay(x, n: int):
    """Delay by n samples, zero-filled (reference src/delay.rs); the output
    keeps the input's length."""
    x = torch.as_tensor(x)
    if n == 0:
        return x
    return torch.cat([x.new_zeros((n, *x.shape[1:])), x])[: x.shape[0]]


def skip(x, n: int):
    """Drop the first n samples (reference src/skip.rs)."""
    return torch.as_tensor(x)[n:]


def head(x, n: int):
    """Pass only the first n samples (reference src/head.rs)."""
    return torch.as_tensor(x)[:n]
