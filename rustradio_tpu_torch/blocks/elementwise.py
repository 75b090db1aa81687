"""Elementwise blocks (port of ``FloatToComplex`` from
``rustradio_tpu/blocks/elementwise.py``)."""

from __future__ import annotations

import torch

from .base import Block


class FloatToComplex(Block):
    """(re, im) f32 streams -> one complex64 stream (reference
    src/convert.rs)."""

    n_in = 2

    def apply(self, re, im):
        return torch.complex(re.float(), im.float())
