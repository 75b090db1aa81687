"""Voltage-controlled oscillator / FM modulator (port of
``rustradio_tpu/ops/vco.py``; reference src/vco.rs).

phase[n] = phase[n-1] + k * x[n] (wrapped), out = sin(phase) + i cos(phase)
— the reference really does output Complex(sin, cos), not (cos, sin)
(src/vco.rs:29-37).  The JAX package sums the phase in f32 and wraps it
into [0, 2*pi) by an exact remainder.  Here the f32 increments k * x are
summed in float64 and wrapped there, then rounded to f32: an f32 sum's
error grows with the phase it reaches (a ~1500 rad phase has an f32 step of
1.2e-4), and torch's parallel scan on the card rounds in an order of its
own, so the two packages would agree only to within that error.  In
float64 the port stays within the f32 rounding of the wrapped phase on
every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def vco(x, k: float, phase0=0.0):
    """Returns (out, final_phase) for streaming continuation, on ``x``'s
    device; ``final_phase`` is a 0-d f32 tensor."""
    x = torch.as_tensor(x).to(torch.float32)
    phase = torch.cumsum((x * float(np.float32(k))).double(), 0)
    phase = phase + torch.as_tensor(phase0, device=x.device).double()
    phase = torch.remainder(phase, 2 * math.pi).float()
    return torch.complex(torch.sin(phase), torch.cos(phase)), phase[-1]
