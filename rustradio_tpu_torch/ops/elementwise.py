"""Elementwise sample ops (port of ``rustradio_tpu/ops/elementwise.py``).

Reference blocks: src/add_const.rs, src/multiply_const.rs, src/xor.rs,
src/xor_const.rs, src/complex_to_mag2.rs, src/binary_slicer.rs,
src/convert.rs.  Each runs on its input's device.
"""

from __future__ import annotations

import torch


def add_const(x, val):
    """x + val (reference src/add_const.rs)."""
    return x + val


def multiply_const(x, val):
    """x * val (reference src/multiply_const.rs)."""
    return x * val


def xor_const(x, val):
    """x ^ val (reference src/xor_const.rs); ``val`` stays a host scalar,
    so nothing is copied to the device per call."""
    return torch.bitwise_xor(x, int(val))


def add(a, b):
    """a + b, two streams (reference src/add.rs)."""
    return a + b


def multiply(a, b):
    return a * b


def xor(a, b):
    """a ^ b (reference src/xor.rs)."""
    return torch.bitwise_xor(a, b)


def complex_to_mag2(x):
    """|x|^2 = re^2 + im^2 (reference src/complex_to_mag2.rs:18-20)."""
    return x.real ** 2 + x.imag ** 2


def binary_slicer(x):
    """float > 0 -> 1u8 else 0u8 (reference src/binary_slicer.rs:17-19)."""
    return (x > 0).to(torch.uint8)


def float_to_complex(re, im=None):
    """(re, im) float streams -> complex64 (reference src/convert.rs:261)."""
    re = torch.as_tensor(re, dtype=torch.float32)
    im = torch.zeros_like(re) if im is None else torch.as_tensor(
        im, dtype=torch.float32, device=re.device)
    return torch.complex(re, im)


def complex_to_float(x):
    """complex -> (re, im) pair of float streams (reference src/convert.rs:290)."""
    return x.real, x.imag


def complex_to_real(x):
    return x.real
