"""A broadcast FM station as rtl-sdr's 8-bit I/Q on the (u8 - 127)/128
wire grid: the traffic's ``tones`` (Hz, amplitude, phase) summed into the
audio, at the configuration's ``deviation_hz``, carrier amplitude
``amplitude``, Gaussian receiver noise ``noise`` a plane before the grid.
The phase is the closed form of the running sum of the audio, so the
same seed gives the same planes on any device."""

from __future__ import annotations

import math

import torch

from . import device_generator


def _wire_grid(v: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 on the (u8 - 127)/128 grid, clamped to [-127, 128]."""
    return (torch.round(torch.clamp(v * 128.0, -127.0, 128.0)) / 128.0).float()


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """The I and Q planes (f32, on ``device``) of ``traffic["samples"]``
    samples."""
    n = int(traffic["samples"])
    fs = float(config["samp_rate"])
    k = 2 * math.pi * float(config["deviation_hz"]) / fs
    t = torch.arange(n, dtype=torch.float64, device=device)
    phase = torch.zeros(n, dtype=torch.float64, device=device)
    for f, a, p in traffic["tones"]:
        # sum_{m=0}^{t} sin(w m + p) = sin((t+1) w/2) sin(p + t w/2) / sin(w/2)
        w = 2 * math.pi * float(f) / fs
        phase += (float(a) / math.sin(w / 2)) * (
            torch.sin((t + 1) * (w / 2)) * torch.sin(p + t * (w / 2)))
    phase *= k
    del t
    gen = device_generator(seed, device)
    amp, noise = float(traffic["amplitude"]), float(traffic["noise"])

    def plane(v):
        return _wire_grid(v + noise * torch.randn(
            n, generator=gen, device=device, dtype=torch.float64))

    i = plane(amp * torch.cos(phase))
    q = plane(amp * torch.sin(phase))
    return {"i": i, "q": q, "n": n}
