"""Elementwise and utility blocks (port of
``rustradio_tpu/blocks/elementwise.py``).  Each runs on its input's
device; ``Inspect`` and ``PduMap`` are host blocks."""

from __future__ import annotations

import torch

from ..ops.elementwise import (
    add,
    add_const,
    binary_slicer,
    complex_to_float,
    complex_to_mag2,
    complex_to_real,
    multiply_const,
    xor,
    xor_const,
)
from .base import Block


class FloatToComplex(Block):
    """(re, im) f32 streams -> one complex64 stream (reference
    src/convert.rs)."""

    graph_capturable = True
    n_in = 2

    def apply(self, re, im):
        return torch.complex(re.float(), im.float())


class AddConst(Block):
    """x + val (reference src/add_const.rs)."""

    graph_capturable = True

    def __init__(self, val):
        self.val = val

    def apply(self, x):
        return add_const(x, self.val)


class MultiplyConst(Block):
    """x * val (reference src/multiply_const.rs)."""

    graph_capturable = True

    def __init__(self, val):
        self.val = val

    def apply(self, x):
        return multiply_const(x, self.val)


class ComplexToMag2(Block):
    """|x|^2 (reference src/complex_to_mag2.rs): the burst gate's power."""

    graph_capturable = True

    def apply(self, x):
        return complex_to_mag2(x)


class BinarySlicer(Block):
    """float > 0 -> 1u8 else 0u8 (reference src/binary_slicer.rs)."""

    graph_capturable = True

    def apply(self, x):
        return binary_slicer(x)


class XorConst(Block):
    """x ^ val (reference src/xor_const.rs)."""

    graph_capturable = True

    def __init__(self, val):
        self.val = val

    def apply(self, x):
        return xor_const(x, self.val)


class Add(Block):
    """a + b, two streams (reference src/add.rs)."""

    graph_capturable = True
    n_in = 2

    def apply(self, a, b):
        return add(a, b)


class Xor(Block):
    """a ^ b (reference src/xor.rs)."""

    graph_capturable = True
    n_in = 2

    def apply(self, a, b):
        return xor(a, b)


class Map(Block):
    """1:1 lambda block (reference src/convert.rs:121-172); ``fn`` runs on
    each chunk's tensor.  ``elementwise=True`` declares ``fn`` pointwise
    (no cross-sample dependence) and sets ``shard_halo`` to 0, as the JAX
    block does; nothing in the port reads it yet."""

    graph_capturable = False  # fn may read the card back or work on the host
    shard_halo: int | None = None  # None = not time-shardable

    def __init__(self, fn, name: str = "Map", elementwise: bool = False):
        self.fn = fn
        self._name = name
        if elementwise:
            self.shard_halo = 0

    def name(self):
        return self._name

    def apply(self, x):
        return self.fn(x)


class Inspect(Block):
    """Pass-through that calls a host lambda on the data, as numpy
    (reference src/convert.rs:25-50)."""

    graph_capturable = False  # host: the lambda sees numpy
    domain = "host"

    def __init__(self, fn, name: str = "Inspect"):
        self.fn = fn
        self._name = name

    def name(self):
        return self._name

    def apply(self, x):
        self.fn(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
        return x


class Tee(Block):
    """1 -> 2 copy with tags on both (reference src/tee.rs)."""

    graph_capturable = True
    n_out = 2

    def apply(self, x):
        return x, x

    def process_tags(self, in_tags, out_lens):
        src = in_tags[0] if in_tags else []
        return [list(src), list(src)]


class ComplexToFloat(Block):
    """complex -> (re, im) streams (reference src/convert.rs:290)."""

    graph_capturable = True
    n_out = 2

    def apply(self, x):
        return complex_to_float(x)


class ComplexToReal(Block):
    """complex -> its real part (reference src/convert.rs)."""

    graph_capturable = True

    def apply(self, x):
        return complex_to_real(x)


class PduMap(Block):
    """PDU lambda block, one PDU in -> zero-or-more PDUs out
    (reference src/convert.rs NCMap :202)."""

    graph_capturable = False  # host: PDUs
    domain = "host"

    def __init__(self, fn, name: str = "PduMap"):
        self.fn = fn
        self._name = name

    def name(self):
        return self._name

    def apply(self, pdus):
        out = []
        for p in pdus:
            r = self.fn(p)
            if r is None:
                continue
            out.extend(r if isinstance(r, (list, tuple)) else [r])
        return out
