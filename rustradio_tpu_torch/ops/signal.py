"""Signal sources (port of ``rustradio_tpu/ops/signal.py``; reference
src/signal_source.rs).

The reference advances the phase *before* emitting each sample and outputs
Complex(sin(t), sin(t - pi/2)) == sin(t) - i*cos(t)
(src/signal_source.rs:38-50).  The phase ramp is generated directly:
t[n] = (offset + n + 1) * rad_per_sample, taken mod 2*pi in float64 (on
the target device: the product and ``fmod`` are exact IEEE operations, so
the values are the JAX package's host numpy ones), then rounded to f32;
``sin`` and ``cos`` run in f32.
"""

from __future__ import annotations

import math

import torch

from .._device import target_device


def _phases(n: int, samp_rate: float, freq: float, offset: int,
            device) -> torch.Tensor:
    rad = 2.0 * math.pi * float(freq) / float(samp_rate)
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device) + float(offset)
    # np.mod: fmod, moved into [0, 2*pi) where it came out negative
    t = torch.fmod(k * rad, 2.0 * math.pi)
    t = torch.where(t < 0, t + 2.0 * math.pi, t)
    return t.to(torch.float32)


def signal_source_c(n: int, samp_rate: float, freq: float,
                    amplitude: float = 1.0, offset: int = 0,
                    device="cuda") -> torch.Tensor:
    """Complex sine: amplitude * (sin t - i cos t), t advancing per sample;
    complex64 on ``device`` (the card unless the caller names another)."""
    device = target_device(device, "signal_source_c")
    t = _phases(n, samp_rate, freq, offset, device)
    a = float(torch.tensor(amplitude, dtype=torch.float32))
    return torch.complex(a * torch.sin(t), -(a * torch.cos(t)))


def signal_source_f(n: int, samp_rate: float, freq: float,
                    amplitude: float = 1.0, offset: int = 0,
                    device="cuda") -> torch.Tensor:
    """Real sine: amplitude * sin(t), f32 on ``device``."""
    device = target_device(device, "signal_source_f")
    t = _phases(n, samp_rate, freq, offset, device)
    return float(torch.tensor(amplitude, dtype=torch.float32)) * torch.sin(t)
