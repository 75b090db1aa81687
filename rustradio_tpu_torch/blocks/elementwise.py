"""Elementwise blocks (port of ``FloatToComplex``, ``AddConst``,
``MultiplyConst``, ``ComplexToMag2`` and ``BinarySlicer`` from
``rustradio_tpu/blocks/elementwise.py``).  Each runs on its input's
device."""

from __future__ import annotations

import torch

from ..ops.elementwise import (
    add_const,
    binary_slicer,
    complex_to_mag2,
    multiply_const,
)
from .base import Block


class FloatToComplex(Block):
    """(re, im) f32 streams -> one complex64 stream (reference
    src/convert.rs)."""

    n_in = 2

    def apply(self, re, im):
        return torch.complex(re.float(), im.float())


class AddConst(Block):
    """x + val (reference src/add_const.rs)."""

    def __init__(self, val):
        self.val = val

    def apply(self, x):
        return add_const(x, self.val)


class MultiplyConst(Block):
    """x * val (reference src/multiply_const.rs)."""

    def __init__(self, val):
        self.val = val

    def apply(self, x):
        return multiply_const(x, self.val)


class ComplexToMag2(Block):
    """|x|^2 (reference src/complex_to_mag2.rs): the burst gate's power."""

    def apply(self, x):
        return complex_to_mag2(x)


class BinarySlicer(Block):
    """float > 0 -> 1u8 else 0u8 (reference src/binary_slicer.rs)."""

    def apply(self, x):
        return binary_slicer(x)
