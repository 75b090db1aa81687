"""Demodulation blocks (port of ``QuadratureDemod`` from
``rustradio_tpu/blocks/demod.py``)."""

from __future__ import annotations

import torch

from ..ops.demod import quadrature_demod
from .base import Block


class QuadratureDemod(Block):
    """FM discriminator (reference src/quadrature_demod.rs:46-113).

    Offline: N-1 outputs.  Streaming: carries one sample, so after the
    first chunk every chunk yields len(x) outputs.
    """

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def apply(self, x):
        return quadrature_demod(x, self.gain)

    def init_state(self):
        return torch.zeros(0, dtype=torch.complex64)

    def apply_chunk(self, state, x):
        # an empty carry (stream start) takes the chunk's device
        ext = x if state.numel() == 0 else torch.cat([state, x])
        return ext[-1:].clone(), quadrature_demod(ext, self.gain)
