"""The synthetic inputs and the float64 models shared by ``chip_smoke.py``
and the benchmark programs (``tools/bench*.py``): an FM station and noise
on rtl-sdr's 8-bit wire grid, the decode bank's noisy NRZ, a wideband
bank's NRZ (bursts between stretches of low-passed noise), APRS audio
(Bell 202 frames between silence at a packet channel's density), the FM chain in
float64 numpy, and the recurrences of kernels F and G (the CMA equalizer
window after window, the IIR filter by its impulse response)."""

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
CMA_TAPS, CMA_MU = 16, 1e-3     # CmaEqualizer(16, 1.0, 1e-3)
CMA_ECHO = complex(0.3 * np.exp(0.7j))  # a pre-echo two samples ahead
CMA_NOISE = 0.01                # complex noise, per component
CMA_TOL = 1e-5          # of max|y| (max|taps|): kernel F against float64, and
                        # calls split elsewhere than at a block of windows
                        # against one call (tests/test_torch_recurrences.py)
IIR_TOL = 5e-6          # of max|y|, kernel G against float64 (iir_f64)
IIR_TAPS = {
    "order 2": (0.05, 1.6, -0.65),  # poles 0.8 +- 0.1j
    # poles 0.95 e^{+-0.3j}, 0.9 e^{+-0.9j}, 0.85 e^{+-1.6j}, 0.8 e^{+-2.4j},
    # unit gain at DC (also tests/test_torch_recurrences.py)
    "order 8": (0.3017025, 1.7045681, -1.5572132, 1.1628689, -0.8696898,
                0.672317, -0.5769415, 0.500414, -0.33802596),
}


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


BAND_CH = 8               # the wideband cell's bank (aprs_wideband.scan):
BAND_N = 1 << 21          # 8 channels of 2^21 samples at 20 kHz,
BAND_SPS = 2.56e6 / 128 / 1200   # 16.67 samples a symbol,
BAND_STATIONS = 6         # six of them keyed a third of the time
BAND_TAPS = (1 / 6,) * 6  # ax25-1200-rx.rs's clock filter (symbol_taps)
BAND_FC = 0.047           # the noise's cut-off, cycles a sample
BAND_FIR = 127            # taps of its low-pass


def band_nrz(device, gen: torch.Generator, rng: np.random.RandomState,
             channels: int = BAND_CH, n: int = BAND_N,
             stations: int = BAND_STATIONS, burst=(10_000, 25_000),
             gap: float = 30_000.0) -> torch.Tensor:
    """A wideband bank's clock-recovery input as the cell's channels give
    it: Gaussian noise low-passed to ``BAND_FC`` (a Hamming-windowed sinc
    of ``BAND_FIR`` taps: ~5.1 crossings in 100 samples, half the gaps 15
    samples or less, as a channel with no station has), and on the first
    ``stations`` channels bursts of ``burst`` samples (uniform) of random
    bits held for ``BAND_SPS`` samples at 3 times the noise's RMS, with 0.3
    of the noise on them, exponential gaps of ``gap`` on average between
    (~4.3 crossings in 100 at the defaults).  (channels, n) f32 on
    ``device``: the noise and the bits from ``gen``, the bursts' times from
    ``rng``."""
    t = np.arange(BAND_FIR) - (BAND_FIR - 1) / 2
    h = np.sinc(2 * BAND_FC * t) * np.hamming(BAND_FIR)
    h = torch.tensor(h / np.sqrt((h ** 2).sum()), dtype=torch.float32,
                     device=device)
    white = torch.randn((channels, 1, n + BAND_FIR - 1), generator=gen,
                        device=device)
    noise = torch.nn.functional.conv1d(white, h.view(1, 1, -1)).view(channels, n)
    nbits = int(n / BAND_SPS) + 2
    bits = torch.randint(0, 2, (channels, nbits), generator=gen,
                         device=device) * 2.0 - 1.0
    at = torch.clamp((torch.arange(n, device=device, dtype=torch.float64)
                      / BAND_SPS).long(), max=nbits - 1)
    keyed = np.zeros((channels, n), bool)
    for c in range(min(stations, channels)):
        i = int(rng.exponential(gap))
        while i < n:
            length = rng.randint(*burst)
            keyed[c, i:i + length] = True
            i += length + int(rng.exponential(gap))
    keyed = torch.from_numpy(keyed).to(device)
    return torch.where(keyed, 3.0 * bits[:, at] + 0.3 * noise, noise).contiguous()


APRS_FS = 44_100.0         # the APRS audio of aprs1200.events:
APRS_N = 1 << 24           # 2^24 samples at 44.1 kHz (6.3 min)
APRS_FRAMES = 158          # with 158 frames (WA8LMF track 1's density)
APRS_SPS = APRS_FS / 1200  # 36.75 samples a symbol
APRS_TAPS = (1 / 6,) * 6   # ax25_1200_rx's clock filter (symbol_taps)
APRS_LEAD = 735            # noise before and after each frame's tones


def aprs_audio(rng: np.random.RandomState, n: int = APRS_N,
               frames: int | None = None) -> np.ndarray:
    """APRS audio as the packet cell's capture has it: ``frames`` AX.25
    UI frames (default: APRS_FRAMES scaled to ``n``, at least 1) of 40-100
    random printable bytes, HDLC-framed with 20 flags each side, NRZI, as
    Bell 202 tones (1200 / 2200 Hz) at 1200 baud x (1 + drift), drift
    -1.5..1.5%, amplitude 0.05-1.0 and noise up to 0.4x of it over the
    tones and their ``APRS_LEAD``-sample leads; silence between the frames,
    exponential gaps.  (n,) f32 numpy, from ``rng``."""
    from ..ops import hdlc

    if frames is None:
        frames = max(1, round(APRS_FRAMES * n / APRS_N))
    amps = np.linspace(0.05, 1.0, 10)
    noises = (0.0, 0.15, 0.3, 0.35, 0.4)
    drifts = np.linspace(-0.015, 0.015, 7)
    bursts = []
    for i in range(frames):
        payload = rng.randint(0x20, 0x7F, rng.randint(40, 101)).astype(np.uint8)
        line = (1 + np.cumsum(1 - hdlc.hdlc_frame(hdlc.fcs_add(payload)))) % 2
        sps = APRS_FS / (1200.0 * (1.0 + drifts[i % len(drifts)]))
        m = int(len(line) * sps)
        freqs = np.where(line[np.minimum((np.arange(m) / sps).astype(int),
                                         len(line) - 1)] == 1, 1200.0, 2200.0)
        amp = amps[rng.randint(len(amps))]
        tone = np.zeros(m + 2 * APRS_LEAD)
        tone[APRS_LEAD:APRS_LEAD + m] = amp * np.sin(np.cumsum(2 * np.pi * freqs
                                                               / APRS_FS))
        bursts.append(tone + rng.randn(tone.size) * (noises[i % 5] * amp))
    free = n - sum(b.size for b in bursts)
    if free < frames + 1:
        raise ValueError(f"{frames} frames do not fit in {n} samples")
    w = rng.exponential(size=frames + 1)
    gaps = np.floor(w / w.sum() * free).astype(int)
    out = np.zeros(n, np.float32)
    at = 0
    for g, b in zip(gaps, bursts):
        at += g
        out[at:at + b.size] = b
        at += b.size
    return out


def cma_channel(phase: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """Kernel F's input: n samples of the station whose phase (float64) is
    ``phase`` at unit modulus through a pre-echo ``CMA_ECHO`` two samples
    ahead, plus complex noise of ``CMA_NOISE`` per component; complex64 on
    the phase's device."""
    dev = phase.device
    s = torch.polar(torch.ones(n + 2, dtype=torch.float64, device=dev),
                    phase[: n + 2])
    noise = torch.randn((2, n), generator=gen, device=dev, dtype=torch.float64)
    return (s[:n] + CMA_ECHO * s[2:] + CMA_NOISE * torch.complex(noise[0], noise[1])
            ).to(torch.complex64)


def cma_sequential(x: np.ndarray, ntaps: int, r: float, mu: float,
                   dtype=np.complex128) -> np.ndarray:
    """``cma_equalize(x, ntaps, r, mu)`` from the default taps, window after
    window on the host (numpy): in float64 (complex128) the model, in f32
    (complex64) the sequential recurrence, each step rounded as the JAX
    reference's ``lax.scan`` rounds it (the sum's order aside)."""
    real = np.float64 if dtype == np.complex128 else np.float32
    r, mu = real(r), real(mu)
    w = np.lib.stride_tricks.sliding_window_view(x.astype(dtype), ntaps)
    t = np.zeros(ntaps, dtype)
    t[0] = 1.0
    ys = np.empty(len(w), dtype)
    for i, wi in enumerate(w):
        y = (t * wi).sum()
        ys[i] = y
        t = t + (mu * (r - (y.real * y.real + y.imag * y.imag))) * y * wi.conj()
    return ys


def iir_f64(x: torch.Tensor, taps, length: int = 2048) -> torch.Tensor:
    """Float64 model of ``iir_filter(x, taps)`` from a zero history: ``x``
    convolved (float64 FFTs, on its device) with the filter's impulse
    response, its first ``length`` samples computed by the recurrence in
    float64.  For the filters of ``IIR_TAPS``, whose poles lie inside
    radius 0.95, what is left out is below 0.95^2048 (1e-45) of the
    response's peak."""
    t = np.asarray(taps, np.float32).astype(np.float64)
    h, hist = np.zeros(length), np.zeros(len(t) - 1)
    for k in range(length):
        h[k] = (t[0] if k == 0 else 0.0) + hist @ t[1:]
        hist = np.concatenate([[h[k]], hist[:-1]])
    n = x.shape[0]
    m = 1 << (n + length - 1).bit_length()
    spec = (torch.fft.rfft(x.double(), m)
            * torch.fft.rfft(torch.from_numpy(h).to(x.device), m))
    return torch.fft.irfft(spec, m)[:n]
