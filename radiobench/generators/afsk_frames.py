"""``frames`` Bell 202 AX.25 frames at random gaps in a capture of
``samples`` audio samples at the configuration's rate.

The frames' amplitudes, clock drifts, noise levels, payload lengths and
the gaps are one fixed set each, drawn from ``amplitudes`` / ``drifts``
/ ``noises`` (frame k takes entry k mod len), ``payload_bytes`` (low,
high: an even spread over the frames) and ``gap_law`` ("exponential":
the quantiles of an exponential spread, scaled to fill the capture); the
seed permutes each set and draws the payloads' text and the noise
samples.  So every seed makes the same amount of work, in another
order."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import hdlc
from . import device_generator, rng


def _payload(r: np.random.Generator, idx: int, size: int) -> bytes:
    """An APRS-style UI payload of ``size`` bytes, unique by ``idx``."""
    head = f"N0CALL-{idx % 16}>APRS,WIDE2-1:>W{idx:05d} ".encode()
    body = r.integers(0x20, 0x7F, max(size - len(head), 0), dtype=np.uint8)
    return head + body.tobytes()


def _spread(values, count: int) -> np.ndarray:
    return np.asarray([values[k % len(values)] for k in range(count)],
                      np.float64)


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """The audio capture (f32 on ``device``) and what was sent:
    ``truth`` = {"payloads": [...] in capture order, "ends": last tone
    sample of each frame, "starts": first sample of each frame's burst}."""
    fs = float(config["samp_rate"])
    if fs != int(fs):
        raise ValueError("afsk_frames needs a whole sample rate")
    fsi = int(fs)
    baud = float(config["baud"])
    mark, space = (int(config["mark_hz"]), int(config["space_hz"]))
    n_total, nf = int(traffic["samples"]), int(traffic["frames"])
    lead = int(traffic["lead_samples"])
    r = rng(seed)
    perm = r.permutation(nf)
    amps = _spread(traffic["amplitudes"], nf)[perm]
    noises = _spread(traffic["noises"], nf)[perm] * amps
    drifts = _spread(traffic["drifts"], nf)[r.permutation(nf)]
    lo, hi = traffic["payload_bytes"]
    sizes = np.round(np.linspace(lo, hi, nf)).astype(int)[r.permutation(nf)]
    payloads = [_payload(r, k, int(sizes[k])) for k in range(nf)]
    lines = [hdlc.nrzi_line(hdlc.hdlc_frame(p, int(traffic["sync_flags"])))
             for p in payloads]
    sps = fs / (baud * (1.0 + drifts))
    tones = np.asarray([int(len(ln) * s) for ln, s in zip(lines, sps)], np.int64)
    spans = tones + 2 * lead
    free = n_total - int(spans.sum())
    if free < nf + 1:
        raise ValueError(f"{nf} frames need {int(spans.sum())} of the "
                         f"{n_total} samples and a gap each")
    if traffic["gap_law"] != "exponential":
        raise ValueError(f"unknown gap_law {traffic['gap_law']!r}")
    w = -np.log1p(-(np.arange(nf + 1) + 0.5) / (nf + 1))[r.permutation(nf + 1)]
    gaps = np.floor(w / w.sum() * free).astype(np.int64)
    gaps[-1] += free - int(gaps.sum())
    starts = np.cumsum(np.concatenate([[0], spans[:-1]])) + np.cumsum(gaps[:-1])
    pos = starts + lead  # first tone sample of each frame

    # the tones: frame f's sample s keys line bit min(s // sps, len - 1)
    dev = torch.device(device)
    line_all = torch.from_numpy(np.concatenate(lines)).to(dev)
    line_off = torch.from_numpy(np.cumsum([0] + [len(x) for x in lines[:-1]])).to(dev)
    line_len = torch.tensor([len(x) for x in lines], device=dev)
    n_t = torch.from_numpy(tones).to(dev)
    fid = torch.repeat_interleave(torch.arange(nf, device=dev), n_t)
    first = torch.cumsum(n_t, 0) - n_t
    s = torch.arange(int(tones.sum()), device=dev) - first[fid]
    sps_t = torch.from_numpy(sps).to(dev)
    bit = torch.minimum(torch.floor(s.double() / sps_t[fid]).long(),
                        line_len[fid] - 1)
    is_mark = line_all[line_off[fid] + bit].long()
    del bit
    # phase = 2 pi / fs * sum over samples <= s of the tone's frequency:
    # counted in whole cycles-times-fs, exact in int64
    marks = torch.cumsum(is_mark, 0)
    marks -= (marks - is_mark)[first][fid]
    cyc = torch.remainder(space * (s + 1) - (space - mark) * marks, fsi)
    del marks, is_mark
    amp_t = torch.from_numpy(amps).to(dev)
    tone = (amp_t[fid] * torch.sin(cyc.double() * (2 * math.pi / fs))).float()
    del cyc
    audio = torch.zeros(n_total, dtype=torch.float32, device=dev)
    audio[torch.from_numpy(pos).to(dev)[fid] + s] = tone
    del tone, s, fid

    # noise over each frame's burst and leads, scaled to the frame
    mark_t = torch.zeros(n_total + 1, dtype=torch.int64, device=dev)
    idx = torch.arange(1, nf + 1, device=dev)
    mark_t[torch.from_numpy(starts).to(dev)] += idx
    mark_t[torch.from_numpy(starts + spans).to(dev)] -= idx
    which = torch.cumsum(mark_t, 0)[:n_total]
    del mark_t
    scale = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev),
                       torch.from_numpy(noises.astype(np.float32)).to(dev)])
    gen = device_generator(seed, dev)
    audio += scale[which] * torch.randn(n_total, generator=gen, device=dev)
    del which
    return {"audio": audio, "n": n_total,
            "truth": {"payloads": payloads, "ends": pos + tones - 1,
                      "starts": starts}}
