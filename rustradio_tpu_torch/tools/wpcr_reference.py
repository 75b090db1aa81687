"""A plain float64 reference of the 1200 bd AX.25 burst receiver with
whole-packet clock recovery, rustradio's examples/ax25-1200-wpcr.rs: a
1205-tap channel filter (20 kHz, Hamming), the FM discriminator, a 65-tap
Hilbert transform, a second discriminator (the AFSK tones to a level), a
2.4 kHz low-pass, the power gate (|x|^2 through a single-pole IIR, cut
at a threshold), the bursts with their tail and size limit, each burst's
midpoint, its clock from one DFT over the whole burst (src/wpcr.rs), the
slicer, NRZI and an HDLC deframer with the CRC-16/X.25 frame check.

Plain torch operations in float64 (complex128) on the input's device,
with TF32 off: no kernel of the program and nothing of JAX.  The same
text is kept twice, as ``rustradio_tpu_torch/tools/wpcr_reference.py``
for the port's tests and as ``radiobench/reference/wpcr_rx.py`` for the
benchmark's check, so that no change to the program moves what the
check expects.

Departures from rustradio, each on purpose:

- float64 throughout, taps designed in float64 (rustradio: f32 samples
  and taps);
- the channel filter, the low-pass and the Hilbert's FIR are direct
  convolutions with zero history, computed as matrix products over blocks
  of outputs (rustradio's FftFilter is an overlap-add FFT: the same sum);
- the resampler is left out: it is the identity at new_rate == samp_rate,
  the only ratio taken here (``front`` raises at any other);
- the single-pole IIR is its closed form over blocks, each block's sum of
  powers of (1 - alpha) one matrix product and the blocks' carries the
  same recurrence over the blocks' ends (rustradio: one multiply-add a
  sample);
- the gate compares the float64 power with the float64 threshold
  (rustradio: both f32);
- a burst still open at the capture's end is dropped (rustradio's
  StreamToPdu waits for its end tag);
- each burst's DFT is ``torch.fft.fft`` in complex128 at the burst's own
  length (rustfft in f32), and the clock's emissions are the closed form
  floor(phase + k * sps) (rustradio accumulates the phase in f32, one
  addition a sample);
- the deframer never repairs a bit (the app's default, no --fix_bits).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

HAMMING_ATTENUATION_DB = 53.0
CHANNEL_CUTOFF_HZ = 20_000.0
LOWPASS_CUTOFF_HZ = 2_400.0
TWIDTH_HZ = 100.0
HILBERT_TAPS = 65
MIN_FRAME, MAX_FRAME = 10, 1500  # the deframer's sizes (bytes)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ---- filter designs (src/fir.rs:591-674, src/window.rs), in float64

def ntaps(samp_rate: float, twidth: float) -> int:
    """The Hamming design's length for a transition width: 53 dB over
    22 transition widths, made odd."""
    t = int(HAMMING_ATTENUATION_DB * samp_rate / (22.0 * twidth))
    return t + 1 if t % 2 == 0 else t


def hamming(n: int, device="cpu") -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    a0 = 25.0 / 46.0
    return a0 - (1.0 - a0) * torch.cos(2.0 * math.pi * k / (n - 1))


def low_pass(samp_rate: float, cutoff: float, twidth: float,
             device="cpu") -> torch.Tensor:
    """Windowed sinc, its DC gain normalised to 1."""
    n = ntaps(samp_rate, twidth)
    m = (n - 1) // 2
    w0 = 2.0 * math.pi * cutoff / samp_rate
    k = torch.arange(n, dtype=torch.float64, device=device) - m
    safe = torch.where(k == 0, torch.ones_like(k), k)
    h = torch.where(k == 0, torch.full_like(k, w0 / math.pi),
                    torch.sin(safe * w0) / (safe * math.pi)) * hamming(n, device)
    return h / h.sum()


def hilbert_taps(n: int, device="cpu") -> torch.Tensor:
    """Odd, antisymmetric 1/i taps at odd i from the middle, windowed,
    scaled by 1 / (2 |alternating sum of the right half|)."""
    if n % 2 != 1:
        raise ValueError("a Hilbert filter has an odd length")
    win = hamming(n, device)
    mid = (n - 1) // 2
    h = torch.zeros(n, dtype=torch.float64, device=device)
    gain = 0.0
    for i in range(1, mid + 1, 2):
        h[mid + i] = win[mid + i] / i
        h[mid - i] = -win[mid - i] / i
        gain = float(h[mid + i]) - gain
    return h / (2.0 * abs(gain))


# ---- the stream

def convolve(x: torch.Tensor, h: torch.Tensor, block: int = 1 << 21) -> torch.Tensor:
    """y[n] = sum_k h[k] x[n - k], x[< 0] = 0, as long as x: real taps over
    a real or complex stream.  Rows of P outputs each read P + T - 1
    inputs, so a block of rows is one product with the (P + T - 1, P)
    matrix of the taps."""
    t = h.numel()
    p = 1 << max(t - 1, 1).bit_length()
    n = x.shape[0]
    rows = -(-n // p)
    xp = torch.cat([x.new_zeros(t - 1), x, x.new_zeros(rows * p - n)])
    j = torch.arange(p + t - 1, device=x.device)[:, None]
    k = torch.arange(p, device=x.device)[None, :] + (t - 1) - j
    mat = torch.where((k >= 0) & (k < t), h[k.clamp(0, t - 1)], 0.0)
    y = x.new_empty(rows * p)
    step = max(1, block // p)
    with no_tf32():
        for r0 in range(0, rows, step):
            r1 = min(rows, r0 + step)
            w = xp[r0 * p: r1 * p + t - 1].unfold(0, p + t - 1, p)
            if w.is_complex():
                out = torch.complex(w.real @ mat, w.imag @ mat)
            else:
                out = w @ mat
            y[r0 * p: r1 * p] = out.reshape(-1)
    return y[:n]


def discriminator(x: torch.Tensor) -> torch.Tensor:
    """arg(conj(x[n]) x[n + 1]): one shorter than x."""
    return torch.angle(torch.conj(x[:-1]) * x[1:])


def hilbert(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """src/hilbert.rs: with xp = zeros(T) ++ x, y[i] = (xp[i + T // 2],
    sum_j taps[j] xp[i + T - 1 - j]), as long as x."""
    t, n = taps.numel(), x.shape[0]
    xp = torch.cat([x.new_zeros(t), x])
    im = convolve(xp[t - 1: t - 1 + n], taps)
    return torch.complex(xp[t // 2: t // 2 + n], im)


def _first_order(u: torch.Tensor, c: float, block: int = 256) -> torch.Tensor:
    """y[n] = c y[n - 1] + u[n], y[-1] = 0."""
    n = u.shape[0]
    b = min(block, max(n, 1))
    nb = -(-n // b)
    pw = c ** torch.arange(b + 1, dtype=torch.float64, device=u.device)
    lag = torch.arange(b, device=u.device)[None, :] - torch.arange(b, device=u.device)[:, None]
    mat = torch.where(lag >= 0, pw[lag.clamp(0, b)], 0.0)
    with no_tf32():
        y = torch.cat([u, u.new_zeros(nb * b - n)]).reshape(nb, b) @ mat
    if nb > 1:
        ends = _first_order(y[:, -1].contiguous(), float(pw[b]), block)
        y = y + torch.cat([ends.new_zeros(1), ends[:-1]])[:, None] * pw[None, 1:]
    return y.reshape(-1)[:n]


def single_pole_iir(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """y[n] = alpha x[n] + (1 - alpha) y[n - 1], y[-1] = 0."""
    return _first_order(alpha * x, 1.0 - alpha)


def front(iq, samp_rate: float, new_rate: float = 50_000.0,
          iir_alpha: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """(power, nrz): the gate's IIR power, and the AFSK tones as a level,
    one sample after the other for every input sample (nrz two shorter)."""
    if float(new_rate) != float(samp_rate):
        raise ValueError("the reference takes new_rate == samp_rate only")
    x = torch.as_tensor(iq).to(torch.complex128)
    dev = x.device
    x = convolve(x, low_pass(samp_rate, CHANNEL_CUTOFF_HZ, TWIDTH_HZ, dev))
    power = single_pole_iir(x.real ** 2 + x.imag ** 2, iir_alpha)
    fm = discriminator(x)
    del x
    afsk = discriminator(hilbert(fm, hilbert_taps(HILBERT_TAPS, dev)))
    del fm
    nrz = convolve(afsk, low_pass(new_rate, LOWPASS_CUTOFF_HZ, TWIDTH_HZ, dev))
    return power, nrz


def cuts(power: torch.Tensor, threshold: float, n: int, max_size: int,
         tail: int) -> tuple[list[tuple[int, int]], int]:
    """The bursts of the gate over the first n samples: ([(first, stop)]
    kept, the count longer than ``max_size``).  A burst opens where the
    power rises above the threshold and closes, ``tail`` samples on, where
    it falls back (src/burst_tagger.rs, src/stream_to_pdu.rs)."""
    up = power[:n] > threshold
    prev = torch.cat([up.new_zeros(1), up[:-1]])
    rises = torch.nonzero(up & ~prev).flatten().cpu().tolist()
    falls = torch.nonzero(~up & prev).flatten().cpu().tolist()
    kept, too_long = [], 0
    for a, e in zip(rises, falls):  # they alternate, a rise first
        stop = min(e + tail, n)
        if stop - a <= max_size:
            kept.append((a, stop))
        else:
            too_long += 1
    return kept, too_long


# ---- one burst (src/wpcr.rs)

def midpoint(v: torch.Tensor) -> torch.Tensor | None:
    """The burst less the midpoint of its median high and median low
    (src/wpcr.rs:53-82): above the mean is high; each median is the
    sorted side's middle entry.  None where a side is empty."""
    mean = v.mean()
    high, low = v[v > mean], v[v <= mean]
    if high.numel() == 0 or low.numel() == 0:
        return None
    hi = torch.sort(high).values[high.numel() // 2]
    lo = torch.sort(low).values[low.numel() // 2]
    return v - (lo + (hi - lo) / 2.0)


def best_bin(mag: torch.Tensor) -> int | None:
    """rustradio's rule over the half spectrum's magnitudes
    (src/wpcr.rs:217-239): the first bin from 2 whose magnitude is above
    0.8 of the largest from bin 2 and above its next bin's; the last bin
    is never taken.  None where there is none."""
    if mag.numel() <= 2:
        return None
    thresh = mag[2:].max() * 0.8
    i = torch.arange(2, mag.numel() - 1, device=mag.device)
    ok = (mag[i] > thresh) & (mag[i] > mag[i + 1])
    hit = torch.nonzero(ok).flatten()
    return None if hit.numel() == 0 else int(i[hit[0]])


def clock(v: torch.Tensor) -> dict | None:
    """src/wpcr.rs process_one over a centred burst: the transitions of its
    slices, their DFT at its own length, the best bin, the samples a
    symbol's inverse ``sps`` = bin / len, the phase from the bin's angle,
    and the symbols where the clock wraps.  None where no clock is found
    or the burst is under 4 samples."""
    if v.numel() < 4:
        return None
    s = (v > 0).to(torch.float64)
    d = (s[:-1] - s[1:]) ** 2
    half = torch.fft.fft(d.to(torch.complex128))[: d.numel() // 2]
    b = best_bin(half.abs())
    if b is None:
        return None
    sps = b / v.numel()
    t = 0.5 + float(torch.angle(half[b])) / (2.0 * math.pi)
    phase = t if t > 0.5 else t + 1.0
    # the accumulator wraps at sample k when floor(phase + k sps) steps
    u = torch.floor(phase + sps * torch.arange(v.numel(), dtype=torch.float64,
                                               device=v.device))
    wraps = torch.cat([(u[:1] >= 1.0), u[1:] > u[:-1]])
    return {"bin": b, "sps": sps, "phase": phase, "syms": v[wraps]}


# ---- bits and frames

def nrzi_decode(bits: np.ndarray) -> np.ndarray:
    """1 where a bit equals the one before it (the line held), the first
    bit compared with 0 (src/nrzi.rs)."""
    bits = np.asarray(bits, np.uint8)
    return 1 ^ bits ^ np.concatenate([np.zeros(1, np.uint8), bits[:-1]])


def crc16_x25(data: bytes) -> int:
    """CRC-16/X.25: reflected 0x1021, initial and final xor 0xFFFF."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
    return crc ^ 0xFFFF


def _frame(bits: list[int], min_size: int) -> bytes | None:
    """The bits between two flags, the closing flag's first 7 still in
    them: the payload where the rest makes whole bytes, at least
    ``min_size`` and 2, whose last two (low byte first) are the CRC of the
    others."""
    bits = bits[:-7]
    if len(bits) % 8 or len(bits) // 8 < max(min_size, 2):
        return None
    raw = np.packbits(np.asarray(bits, np.uint8), bitorder="little").tobytes()
    data, fcs = raw[:-2], raw[-2] | raw[-1] << 8
    return data if crc16_x25(data) == fcs else None


def hdlc_deframe(bits, min_size: int = MIN_FRAME,
                 max_size: int = MAX_FRAME) -> list[bytes]:
    """src/hdlc_deframer.rs: hunt for the flag 0x7E (LSB first), then
    collect bits, dropping the 0 stuffed after five 1s; six 1s and a 0 is
    the next flag, which ends the frame; seven 1s, or more than
    ``max_size`` bytes, lose the sync until the next flag."""
    out: list[bytes] = []
    shift, synced, final, ones = 0xFF, False, False, 0
    cur: list[int] = []
    for bit in np.asarray(bits, np.uint8).tolist():
        if not synced:
            shift = (shift >> 1) | (bit << 7)
            if shift == 0x7E:
                synced, final, ones, cur = True, False, 0, []
            continue
        if final:
            if bit or len(cur) < 7:
                synced, final, shift = False, False, 0xFF
                continue
            got = _frame(cur, min_size)
            if got is not None:
                out.append(got)
            final, ones, cur = False, 0, []
            continue
        if len(cur) > max_size * 8:
            synced, shift = False, 0xFF
            continue
        if bit:
            cur.append(1)
            if ones == 5:
                final = True
            else:
                ones += 1
        elif ones == 5:
            ones = 0  # a stuffed 0
        else:
            cur.append(0)
            ones = 0
    return out


# ---- the receiver

def receive(iq, samp_rate: float = 50_000.0, new_rate: float = 50_000.0,
            iir_alpha: float = 0.01, threshold: float = 1e-4,
            tail: int = 50) -> dict:
    """The receiver over a capture, bursts up to ``new_rate`` samples:
    {"power", "nrz": the streams; "cuts", "too_long"; "bursts": one dict a
    cut whose midpoint exists (its "cut", and "bin", "sps", "phase" and
    "frames" where its clock was found); "frames": every frame, in
    order}."""
    power, nrz = front(iq, samp_rate, new_rate, iir_alpha)
    n = min(power.shape[0], nrz.shape[0])
    kept, too_long = cuts(power, threshold, n, int(new_rate), tail)
    bursts, frames = [], []
    for a, b in kept:
        v = midpoint(nrz[a:b])
        if v is None:
            continue
        got = clock(v)
        one = {"cut": (a, b)}
        if got is not None:
            bits = (got.pop("syms") > 0).to(torch.uint8).cpu().numpy()
            got["frames"] = hdlc_deframe(nrzi_decode(bits))
            frames += got["frames"]
            one.update(got)
        bursts.append(one)
    return {"power": power, "nrz": nrz, "cuts": kept, "too_long": too_long,
            "bursts": bursts, "frames": frames}
