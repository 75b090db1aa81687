"""FM demodulation (port of ``rustradio_tpu/ops/demod.py`` and of the
polynomial ``fast_atan2`` in ``rustradio_tpu/ops/pallas_kernels.py:63-88``).

* ``quadrature_demod`` — reference src/quadrature_demod.rs:46-113:
  y[n] = gain * atan2(im, re) of conj(x[n]) * x[n+1].  One-sample halo.
* ``fast_fm`` — reference src/quadrature_demod.rs:144-165 (Lyons p.760).
* ``fast_atan2`` — the octant reduction + 7th-order odd polynomial the
  fused FM kernel uses (|err| < 1e-4 rad).  ``csrc/fast_atan2.cuh`` holds
  the same constants for kernels B and C.
"""

from __future__ import annotations

import math

import torch

# the 7th-order odd arctan polynomial on [0, 1], highest degree last
ATAN_POLY = (0.9998660, -0.3302995, 0.1801410, -0.0851330, 0.0208351)


def _atan_poly(z):
    z2 = z * z
    c0, c1, c2, c3, c4 = ATAN_POLY
    return z * (c0 + z2 * (c1 + z2 * (c2 + z2 * (c3 + z2 * c4))))


def fast_atan2(y, x):
    """Branch-free atan2 via the octant reduction + odd polynomial (f32)."""
    abs_y = y.abs()
    abs_x = x.abs()
    mx = torch.maximum(abs_x, abs_y)
    mn = torch.minimum(abs_x, abs_y)
    z = mn / mx.clamp_min(1e-37)
    a = _atan_poly(z)
    a = torch.where(abs_y > abs_x, math.pi / 2 - a, a)
    a = torch.where(x < 0, math.pi - a, a)
    return torch.where(y < 0, -a, a)


def demod_pairs(pr, pi, cr, ci, gain: float = 1.0):
    """gain * fast_atan2 of conj(prev) * cur, on real/imag planes."""
    dr = pr * cr + pi * ci
    di = pr * ci - pi * cr
    return gain * fast_atan2(di, dr)


def quadrature_demod(x, gain: float = 1.0):
    """y[n] = gain * arg(conj(x[n]) * x[n+1]); output length N-1 (f32)."""
    d = torch.conj(x[:-1]) * x[1:]
    return gain * torch.atan2(d.imag.float(), d.real.float())


def fast_fm(x):
    """FastFM discriminator; output length N, zero-initialized history.

    out[n] = (x[n].im - x[n-2].im) * x[n-1].re
           - (x[n].re - x[n-2].re) * x[n-1].im,  x[<0] = 0.
    """
    re = x.real.float()
    im = x.imag.float()
    re1 = torch.nn.functional.pad(re, (1, 0))[:-1]
    im1 = torch.nn.functional.pad(im, (1, 0))[:-1]
    re2 = torch.nn.functional.pad(re, (2, 0))[:-2]
    im2 = torch.nn.functional.pad(im, (2, 0))[:-2]
    return (im - im2) * re1 - (re - re2) * im1
