"""Whole-packet clock recovery (Ossmann method) and burst midpointing (port
of ``rustradio_tpu/ops/wpcr.py``; reference src/wpcr.rs).

One FFT over the whole burst instead of a per-sample feedback loop.

``wpcr`` (src/wpcr.rs:130-197):
1. slice the burst at 0, mark zero transitions: d[n] = ((s[n]>0) -
   (s[n+1]>0))^2, n < len-1;
2. the DFT of d at its own length, len-1;
3. best bin: the first bin >= 2 whose magnitude is > 80% of the maximum
   and not rising (src/wpcr.rs:217-239);
4. sps = bin / len; the clock phase from the bin's phase; emit the sample
   wherever the phase accumulator wraps (closed form, as the JAX package).

``midpoint`` (src/wpcr.rs:53-82): re-centre a burst on the midpoint of the
median high and low levels.

Batches (``wpcr_batch``, ``midpoint_batch``) pad the bursts of one
power-of-two bucket into rows and run each step once for all of them, on
the bursts' device.  The DFT of each row at its own length m - 1 is the
chirp-Z (Bluestein) form over the bucket, as in the JAX package: two
forward and one inverse FFT of length 2L for the whole bucket, whatever
the bursts' lengths, so the FFT plans are per bucket (``prewarm_buckets``
makes them before the first burst).  It runs in complex128 with the chirp
angles reduced mod 2M in int64: the transform of the 0/1 input is then
exact to ~1e-15, so the best bin is the true DFT's and the card and the
CPU pick the same one (the f32 FFTs of numpy and of the JAX package differ
from it by ~1e-7; ``info["near_tie"]`` flags a burst where that could
matter).  The median levels are the k-th smallest valid values, by a sort
with the other entries at +inf (the JAX package's bit search exists to
spare TPU compile time).  The mean that splits high from low is summed in
float64 and rounded to f32.
"""

from __future__ import annotations

import math
import os
import threading

import numpy as np
import torch

_NEAR = 1e-5  # relative distance of a near tie in the best-bin rule


def _rows_midpoint(v: torch.Tensor, m: torch.Tensor):
    """midpoint() over the first m[b] entries of each row of ``v`` (B, L):
    (centred rows, zero past m; ok)."""
    L = v.shape[1]
    k = torch.arange(L, device=v.device)
    valid = k[None, :] < m[:, None]
    mean = (torch.where(valid, v, 0.0).double().sum(1)
            / m.clamp(min=1).double()).float()
    gt = v > mean[:, None]
    above = valid & gt
    below = valid & ~gt
    n_above = above.sum(1)
    n_below = m - n_above
    inf = torch.tensor(math.inf, device=v.device)

    def kth(sel, idx):
        srt = torch.sort(torch.where(sel, v, inf), 1).values
        return srt.gather(1, idx.clamp(max=L - 1)[:, None])[:, 0]

    high = kth(above, n_above // 2)
    low = kth(below, n_below // 2)
    offset = low + (high - low) / 2.0
    ok = (n_above > 0) & (n_below > 0)
    return torch.where(valid, v - offset[:, None], 0.0), ok


def _rows_dft(d: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """The DFT of length M[b] of the first M[b] entries of each row of
    ``d`` (B, L), M <= L, by chirp-Z in complex128: bins j < M[b] of the
    result are the row's DFT."""
    B, L = d.shape
    t = torch.arange(L, dtype=torch.int64, device=d.device)
    t2 = (t * t)[None, :] % (2 * M[:, None])
    ang = -math.pi * t2.double() / M[:, None].double()
    w = torch.polar(torch.ones_like(ang), ang)
    valid = t[None, :] < M[:, None]
    a = torch.where(valid, d, 0.0) * w
    bv = torch.where(valid, w.conj(), 0.0)
    z = a.new_zeros(B, L)
    # the circular chirp: b[s] = b[2L - s] = conj(w[s])
    b = torch.cat([bv, z[:, :1], bv[:, 1:].flip(1)], 1)
    conv = torch.fft.ifft(torch.fft.fft(torch.cat([a, z], 1))
                          * torch.fft.fft(b))[:, :L]
    return w * conv


def _rows_wpcr(v: torch.Tensor, m: torch.Tensor):
    """wpcr() over the first m[b] entries of each row of ``v`` (B, L):
    (mask, sps, phase, found, bin, near_tie), per row."""
    B, L = v.shape
    k = torch.arange(L, device=v.device)
    valid = k[None, :] < m[:, None]
    sliced = torch.where(valid, (v > 0).double(), 0.0)
    s1 = torch.cat([sliced[:, 1:], sliced.new_zeros(B, 1)], 1)
    d = torch.where(k[None, :] < (m - 1)[:, None], (sliced - s1) ** 2, 0.0)
    spec = _rows_dft(d, (m - 1).clamp(min=1))
    half = ((m - 1) // 2)[:, None]
    inf = math.inf
    mag = torch.where(k[None, :] < half, spec.abs(), -inf)
    eligible = (k[None, :] >= 2) & (k[None, :] < half)
    thresh = torch.where(eligible, mag, -inf).amax(1, keepdim=True) * 0.8
    nxt = torch.cat([mag[:, 1:], mag.new_full((B, 1), inf)], 1)
    cand = eligible & (k[None, :] < half - 1)
    ok = cand & (mag > thresh) & (mag > nxt)
    found = ok.any(1) & (m >= 4) & (half[:, 0] > 2)
    bin_ = ok.to(torch.uint8).argmax(1)  # the first True
    # a near tie: a candidate up to the winner within _NEAR of the
    # threshold, or above it and within _NEAR of its neighbour
    upto = cand & (k[None, :] <= torch.where(found, bin_, L)[:, None])
    near = upto & (((mag - thresh).abs() <= _NEAR * thresh)
                   | ((mag > thresh * (1 - _NEAR))
                      & ((mag - nxt).abs() <= _NEAR * mag)))
    sps = bin_.float() / m.float()
    sb = spec.gather(1, bin_[:, None])[:, 0]
    t = (0.5 + torch.atan2(sb.imag, sb.real) / (2.0 * math.pi)).float()
    phase0 = torch.where(t > 0.5, t, t + 1.0)
    # closed form of the leaky accumulator: with u_k = phase0 + k*sps the
    # cumulative emission count is floor(u_{k-1}); sample k emits iff
    # floor(u_k) > floor(u_{k-1}), and k = 0 iff u_0 >= 1
    unwrapped = phase0[:, None] + k.float()[None, :] * sps[:, None]
    fl = torch.floor(unwrapped)
    mask = torch.cat([unwrapped[:, :1] >= 1.0, fl[:, 1:] > fl[:, :-1]], 1)
    mask = mask & found[:, None] & valid
    return mask, sps, phase0, found, bin_, near.any(1)


def _bucket(v: torch.Tensor, m: torch.Tensor, do_midpoint: bool):
    """One bucket of padded bursts: (centred or given rows, mask, sps,
    phase, found, bin, near_tie)."""
    if do_midpoint:
        v, mid_ok = _rows_midpoint(v, m)
    else:
        mid_ok = torch.ones_like(m, dtype=torch.bool)
    mask, sps, phase, found, bin_, near = _rows_wpcr(v, m)
    return (v, mask & mid_ok[:, None], sps, phase, found & mid_ok, bin_,
            near & mid_ok)


def _burst_tensor(b, device) -> torch.Tensor:
    if torch.is_tensor(b):
        return b.to(torch.float32)
    if device is None:
        raise ValueError("numpy bursts need device= (e.g. 'cuda' or 'cpu')")
    return torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device)


def _bucket_len(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


def _padded(bursts: list, idxs: list[int], L: int, rows: int):
    """The bursts ``idxs`` as the first rows of a (rows, L) zero-padded
    tensor, and their lengths."""
    seqs = [bursts[i] for i in idxs]
    v = torch.nn.utils.rnn.pad_sequence(seqs, batch_first=True)
    v = torch.nn.functional.pad(v, (0, L - v.shape[1], 0, rows - v.shape[0]))
    m = torch.tensor([len(s) for s in seqs] + [0] * (rows - len(seqs)),
                     dtype=torch.int64)
    return v, m.to(v.device)


def midpoint(v):
    """Re-centre a burst around the midpoint of its median high and median
    low (reference Midpointer, src/wpcr.rs:53-82): partition by the mean;
    high = sorted(above)[len/2], low = sorted(below)[len/2].  Returns
    (centred, ok); ``ok`` is False when one side is empty (callers drop
    such bursts, as the reference does)."""
    v = torch.as_tensor(v).to(torch.float32)
    n = v.shape[0]
    c, ok = _rows_midpoint(v[None], torch.tensor([n], device=v.device))
    return c[0], ok[0]


def wpcr(samples, samp_rate: float | None = None):
    """Whole-packet clock recovery over one burst, on its device.

    Returns (syms, mask, info): syms is the input, mask (input length)
    marks the emitted symbols, info holds ``sps``, ``phase`` and ``found``
    (0-d tensors).  Matches reference process_one (src/wpcr.rs:130-197);
    bursts shorter than 4 samples or with no FFT peak give an all-False
    mask.
    """
    del samp_rate
    samples = torch.as_tensor(samples).to(torch.float32)
    n = samples.shape[0]
    if n < 4:
        z = samples.new_zeros(())
        return samples, torch.zeros(n, dtype=torch.bool, device=samples.device), \
            dict(sps=z, phase=z, found=torch.zeros((), dtype=torch.bool,
                                                   device=samples.device))
    mask, sps, phase, found, _, _ = _rows_wpcr(
        samples[None], torch.tensor([n], device=samples.device))
    return samples, mask[0], dict(sps=sps[0], phase=phase[0], found=found[0])


def _not_found(device) -> tuple:
    return (torch.zeros(0, dtype=torch.float32, device=device),
            dict(sps=0.0, phase=0.0, found=False, bin=0, near_tie=False))


def wpcr_batch(bursts, midpoint_first: bool = True, device=None):
    """Batched WPCR over many bursts, on their device.

    Buckets the bursts into power-of-two padded lengths and runs each
    bucket once (midpoint, the chirp-Z DFT at each burst's own length, the
    best bin and the symbol mask), reading back one small table per bucket.
    Bursts are tensors (on their device) or numpy arrays with ``device=``.

    Returns a list aligned with ``bursts``: each entry is ``(syms, info)``,
    syms a tensor on the bursts' device and info a dict of ``sps``,
    ``phase``, ``found`` (as the JAX package), ``bin`` (the best bin) and
    ``near_tie`` (see the module docstring); ``found=False`` entries have
    empty syms, mirroring the reference's process_one returning None.
    """
    tensors = [_burst_tensor(b, device) for b in bursts]
    results: list = [None] * len(tensors)
    buckets: dict[int, list[int]] = {}
    for i, b in enumerate(tensors):
        if len(b) < 4:
            results[i] = _not_found(b.device)
            continue
        buckets.setdefault(_bucket_len(len(b)), []).append(i)
    for L, idxs in buckets.items():
        # the batch rounds up to a power of two (zero-length rows), which
        # bounds the FFT plans and lets prewarm_buckets hit real shapes
        rows = 1 << (len(idxs) - 1).bit_length()
        v, m = _padded(tensors, idxs, L, rows)
        v, mask, sps, phase, found, bin_, near = _bucket(v, m, midpoint_first)
        counts = mask.sum(1)
        flat = v[mask]
        table = torch.stack([sps.double(), phase.double(), found.double(),
                             bin_.double(), near.double(),
                             counts.double()], 1).cpu().tolist()
        syms = torch.split(flat, [int(r[5]) for r in table])
        for row, i in enumerate(idxs):
            s, p, f, b, nt, _ = table[row]
            if not f:
                results[i] = _not_found(v.device)
                results[i][1].update(bin=int(b), near_tie=bool(nt))
                continue
            results[i] = (syms[row], dict(sps=s, phase=p, found=True,
                                          bin=int(b), near_tie=bool(nt)))
    return results


def midpoint_batch(bursts, device=None):
    """Batched Midpointer: a list of (centred, ok) pairs, the centred bursts
    as tensors on the bursts' device."""
    tensors = [_burst_tensor(b, device) for b in bursts]
    results: list = [None] * len(tensors)
    buckets: dict[int, list[int]] = {}
    for i, b in enumerate(tensors):
        if len(b) == 0:
            results[i] = (b, False)
            continue
        buckets.setdefault(_bucket_len(len(b)), []).append(i)
    for L, idxs in buckets.items():
        v, m = _padded(tensors, idxs, L, len(idxs))
        c, ok = _rows_midpoint(v, m)
        ok = ok.cpu().tolist()
        for row, i in enumerate(idxs):
            results[i] = (c[row, : len(tensors[i])], bool(ok[row]))
    return results


_PREWARM_STOP = threading.Event()


def prewarm_buckets(lengths=(2048, 4096, 8192, 16384, 32768),
                    batches=(1,), midpoint_first: bool = True,
                    background: bool = True, device="cuda"):
    """Run each WPCR bucket shape (batch, length) once on the card before
    the first burst, so that the cuFFT plans of its chirp-Z transform exist
    when a burst arrives (reference context: src/wpcr.rs:130-197 builds its
    FFT plan per burst).

    Returns the thread (``background=True``) or None after running inline;
    None at once on a CPU device (no plans to make there).
    ``RR_NO_PREWARM=1`` disables it (the test suite sets it: a warming
    thread would run beside other measurements).
    """
    from .._device import target_device

    if os.environ.get("RR_NO_PREWARM"):
        return None
    device = target_device(device, "prewarm_buckets")
    if device.type != "cuda":
        return None
    stop = _PREWARM_STOP

    def _warm():
        for L in lengths:
            for B in batches:
                if stop.is_set():
                    return
                v = torch.zeros((int(B), int(L)), device=device)
                m = torch.zeros(int(B), dtype=torch.int64, device=device)
                _bucket(v, m, midpoint_first)
        torch.cuda.synchronize(device)

    if not background:
        _warm()
        return None
    # not a daemon: the interpreter raises the stop flag before it joins
    # threads, so exit waits for one bucket at most
    t = threading.Thread(target=_warm, name="wpcr-prewarm", daemon=False)
    threading._register_atexit(stop.set)
    t.start()
    return t


def wpcr_numpy(samples: np.ndarray, samp_rate=None):
    """Host golden model: literal port of reference process_one."""
    samples = np.asarray(samples, np.float32)
    if len(samples) < 4:
        return None
    sliced = (samples > 0).astype(np.float32)
    d = (sliced[:-1] - sliced[1:]) ** 2
    spec = np.fft.fft(d.astype(np.complex64))
    half = spec[: len(d) // 2]
    mag = np.abs(half)
    skip = 2
    if len(mag) <= skip:
        return None
    thresh = mag[skip:].max() * 0.8
    bin_ = None
    for i in range(skip, len(mag) - 1):
        if mag[i] > thresh and mag[i] > mag[i + 1]:
            bin_ = i
            break
    if bin_ is None:
        return None
    sps = np.float32(bin_) / np.float32(len(samples))
    arg = np.angle(half[bin_])
    t = 0.5 + arg / (2 * np.pi)
    clock_phase = t if t > 0.5 else t + 1.0
    syms = []
    for s in samples:
        if clock_phase >= 1.0:
            clock_phase -= 1.0
            syms.append(s)
        clock_phase += sps
    return np.asarray(syms, np.float32), float(sps), float(clock_phase)
