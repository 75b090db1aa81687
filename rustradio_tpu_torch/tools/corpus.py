"""The synthetic inputs and the float64 model shared by ``chip_smoke.py``
and the benchmark programs (``tools/bench*.py``): an FM station and noise
on rtl-sdr's 8-bit wire grid, the decode bank's noisy NRZ, and the FM
chain in float64 numpy."""

from __future__ import annotations

import math

import numpy as np
import torch

DECI = 4                  # the FM chain's decimation
BANK_CH = 64              # bench.py's decode bank (bench.py:223-232):
BANK_N = 1 << 16          # 64 channels x 2^16 NRZ samples at sps 36.75,
BANK_SPS = 36.75          # noise 0.1, default clock taps
BANK_NOISE = 0.1
BANK_EVENTS = 7133        # slot budget, 4 * 2^16 / 36.75


def fm_taps() -> np.ndarray:
    """The FM chain's 49 taps: the real part of the reference's
    micro-benchmark filter, low_pass_complex(1.024 MHz, 100 kHz, 50 kHz)."""
    from .. import taps as tapgen

    return np.real(tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0,
                                           "hamming")).astype(np.float32)


def rtl_fm_iq(n: int, device, gen: torch.Generator):
    """A wideband FM station as 8-bit rtl-sdr I/Q on the (u8-127)/128 grid:
    two audio tones at 75 kHz deviation, plus receiver noise.  Returns the
    f32 I and Q planes and the f64 phase.  The phase's running sum is taken
    on the host: the card's float64 scan adds its tiles in an order that
    varies from run to run, and the CMA checks of phase 14 follow its last
    bits."""
    fs, dev = 1_024_000.0, 75_000.0
    t = torch.arange(n, dtype=torch.float64, device=device)
    audio = (0.6 * torch.sin(2 * math.pi * 1000.0 / fs * t)
             + 0.3 * torch.sin(2 * math.pi * 3100.0 / fs * t + 0.5))
    phase = torch.cumsum(audio.cpu(), 0).to(device) * (2 * math.pi * dev / fs)
    del t, audio

    def grid(v):
        v = v + 0.02 * torch.randn(n, generator=gen, device=device,
                                   dtype=torch.float64)
        return (torch.round(torch.clamp(v * 128, -127, 128)) / 128).float()

    return grid(0.45 * torch.cos(phase)), grid(0.45 * torch.sin(phase)), phase


def wire_noise(shape, device, gen: torch.Generator) -> torch.Tensor:
    """Gaussian noise on the (u8-127)/128 wire grid, as bench.py makes its
    I and Q (bench.py:134-136): round(clip(38 N(0, 1))) / 128, clipped to
    the grid's [-127, 128] (bench.py's [-128, 127] holds -128, which no u8
    byte gives and an int8 plane cannot carry)."""
    v = torch.randn(shape, generator=gen, device=device)
    return torch.round(torch.clamp(v * 38, -127, 128)) / 128


def fir_deci_f64(x: np.ndarray, taps, deci: int) -> np.ndarray:
    """Float64 y[m] = sum_j taps[j] x[m*deci - j], zero history, ceil(n/deci)
    outputs (benches/check_fm_accuracy.py:37-44)."""
    n = len(x)
    m = -(-n // deci)
    acc = np.zeros(m, np.float64)
    xp = np.concatenate([np.zeros(len(taps) - 1), x.astype(np.float64)])
    for j, t in enumerate(np.asarray(taps, np.float64)):
        acc += xp[len(taps) - 1 - j : len(taps) - 1 - j + n : deci][:m] * t
    return acc


def fm_chain_f64(xr: np.ndarray, xi: np.ndarray, taps, gain: float = 1.0,
                 deci: int = DECI) -> np.ndarray:
    """Float64 numpy model of the FM chain: the FIR on both planes,
    decimate, exact discriminator; ceil(n/deci) - 1 outputs
    (benches/check_fm_accuracy.py:47-52)."""
    y = fir_deci_f64(xr, taps, deci) + 1j * fir_deci_f64(xi, taps, deci)
    d = np.conj(y[:-1]) * y[1:]
    return gain * np.arctan2(d.imag, d.real)


def decode_bank(device, gen: torch.Generator, channels: int = BANK_CH,
                n: int = BANK_N) -> torch.Tensor:
    """bench.py's decode-bank input: random bits held for round(sps)
    samples, plus Gaussian noise, (BANK_CH, BANK_N) f32 on the card."""
    rep = int(round(BANK_SPS))
    bits = torch.randint(0, 2, (channels, n // rep + 1), generator=gen,
                         device=device) * 2.0 - 1.0
    nrz = torch.repeat_interleave(bits, rep, dim=1)[:, :n]
    return (nrz + BANK_NOISE * torch.randn(nrz.shape, generator=gen,
                                           device=device)).contiguous()
