"""The wideband receiver's plain reference in float64: the two stages of
``models.multichannel.decode_band_ax25`` that hold it to the band's
arithmetic, written from their definitions in plain torch.

- ``ddc_channels_f64``: each channel as a digital down-converter, the form
  that ``parallel.channelizer.pfb_channelize``'s docstring states: mix the
  capture by exp(-2 pi j k n / M), convolve it with the prototype taps
  from zero history, keep every M-th sample.  No polyphase split and no
  FFT, so it shares no step with the channelizer it checks.
- ``discriminator_f64``: the exact FM discriminator, atan2 of
  conj(y[n]) * y[n + 1].

It imports no JAX and no kernel of the port, and computes in float64,
which no TF32 setting touches.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _mix(x: torch.Tensor, k: int, M: int, n0: int) -> torch.Tensor:
    """x[n] * exp(-2 pi j k (n0 + n) / M), the angle from the exact
    residue of k (n0 + n) modulo M."""
    n = torch.arange(n0, n0 + x.shape[0], dtype=torch.int64, device=x.device)
    angle = torch.remainder(n * k, M).double() * (-2.0 * math.pi / M)
    return x * torch.polar(torch.ones_like(angle), angle)


def ddc_channels_f64(x, taps, M: int, frames=None) -> torch.Tensor:
    """(frames, M) complex128: ``y[i, k] = sum_j h[j] * z[i*M - j]`` with
    ``z[n] = x[n] * exp(-2 pi j k n / M)`` for channel k, ``x[n] = 0``
    before the capture.

    ``frames`` is a ``(first, stop)`` pair of output frames (all
    ``len(x) // M`` by default), so a long capture can be checked in blocks
    that each read only the samples they need.  ``x`` is a complex tensor
    or numpy array, ``taps`` the real prototype; the work runs on ``x``'s
    device."""
    x = torch.as_tensor(x)
    h = torch.as_tensor(np.asarray(taps, np.float64), device=x.device)
    L = h.shape[0]
    first, stop = (0, x.shape[0] // M) if frames is None else frames
    n0 = first * M - (L - 1)  # the first sample that output ``first`` reads
    seg = x[max(n0, 0):stop * M].to(torch.complex128)
    if n0 < 0:
        seg = F.pad(seg, (-n0, 0))  # zero history
    w = h.flip(0).view(1, 1, L)
    out = []
    for k in range(M):
        z = torch.view_as_real(_mix(seg, k, M, n0)).T.reshape(2, 1, -1)
        y = F.conv1d(z, w, stride=M)[:, 0, :stop - first]
        out.append(torch.complex(y[0], y[1]))
    return torch.stack(out, 1)


def discriminator_f64(y) -> torch.Tensor:
    """The FM discriminator of complex streams along their last axis, in
    float64: ``atan2(Im d, Re d)`` with ``d = conj(y[n]) * y[n + 1]``."""
    y = torch.as_tensor(y).to(torch.complex128)
    d = torch.conj(y[..., :-1]) * y[..., 1:]
    return torch.atan2(d.imag, d.real)
