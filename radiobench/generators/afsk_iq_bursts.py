"""1200 bd Bell 202 AX.25 frames as a 50 kHz I/Q capture of one FM
channel: each frame a narrowband FM carrier keyed only while its frame's
tones are, over complex white noise that covers the whole capture.

The frames are ``afsk_frames``'s at the capture's rate (its unit-amplitude
tones with no noise, its payloads framed by ``reference.hdlc``, its
exponential gaps and clock drifts, from the run's seed) with
``lead_samples`` 0, so the carrier rises on the first flag's first tone
sample and falls after the last.  The tones frequency modulate the carrier
at the configuration's ``deviation_hz``; each frame's carrier has its own
amplitude (``amplitudes``) and offset from the channel's centre
(``offsets_hz``, whole Hz), one fixed set each (frame k takes entry k mod
len), permuted by a generator of the seed's own (not ``afsk_frames``'s).
The noise is complex with a total power of ``noise_power``.  So every
seed makes the same amount of work, in another order.

The carrier's phase is counted exactly (the offset's whole Hz times the
sample index, modulo the whole sample rate) and the modulation's phase is
the running sum of the tones in float64."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import SEED_MASK, afsk_frames, device_generator, rng


def _spread(values, count: int) -> np.ndarray:
    return np.asarray([values[k % len(values)] for k in range(count)], np.float64)


def frame_drifts(traffic: dict, seed: int) -> np.ndarray:
    """The clock drift of each frame in capture order: ``afsk_frames``'s
    draws from the seed, repeated (its first permutation orders the
    amplitudes, its second the drifts)."""
    nf = int(traffic["frames"])
    r = rng(seed)
    r.permutation(nf)
    return _spread(traffic["drifts"], nf)[r.permutation(nf)]


def frame_sets(traffic: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(carrier amplitude, carrier offset in Hz) of each frame in capture
    order."""
    nf = int(traffic["frames"])
    r = np.random.default_rng([seed & SEED_MASK, 1])
    amps = _spread(traffic["amplitudes"], nf)[r.permutation(nf)]
    offsets = _spread(traffic["offsets_hz"], nf)[r.permutation(nf)]
    if np.any(offsets != np.round(offsets)):
        raise ValueError("afsk_iq_bursts takes carrier offsets in whole Hz")
    return amps, offsets.astype(np.int64)


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """The capture, ``iq`` (complex64, ``traffic["samples"]`` on
    ``device``), and what was sent: ``truth`` = {"payloads" in capture
    order; "starts", "ends": each frame's first and last keyed sample;
    "amplitudes", "offsets_hz", "drifts": one a frame}."""
    fs = float(config["samp_rate"])
    if fs != int(fs):
        raise ValueError("afsk_iq_bursts needs a whole sample rate")
    if int(traffic["lead_samples"]) != 0:
        raise ValueError("afsk_iq_bursts keys the carrier with the tones: "
                         "lead_samples has to be 0")
    fsi, n = int(fs), int(traffic["samples"])
    dev = torch.device(device)
    one = {k: traffic[k] for k in ("samples", "frames", "drifts", "payload_bytes",
                                   "gap_law", "lead_samples", "sync_flags")}
    one.update(amplitudes=[1.0], noises=[0.0])
    audio_config = {k: config[k] for k in ("samp_rate", "baud", "mark_hz",
                                           "space_hz")}
    sent = afsk_frames.make(one, audio_config, seed, dev)
    audio, truth = sent["audio"], sent["truth"]
    del sent
    amps, offsets = frame_sets(traffic, seed)
    starts, ends = np.asarray(truth["starts"]), np.asarray(truth["ends"])

    # each sample's frame, counted from 1 (0 where the carrier is off)
    nf = len(starts)
    edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    number = torch.arange(1, nf + 1, dtype=torch.int32, device=dev)
    edge[torch.from_numpy(starts).to(dev)] += number
    edge[torch.from_numpy(ends + 1).to(dev)] -= number
    which = torch.cumsum(edge, 0, dtype=torch.int32)[:n].long()
    del edge
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    off = torch.cat([zero, torch.from_numpy(offsets).to(dev)])[which]
    amp = torch.cat([zero.float(), torch.from_numpy(amps).to(dev).float()])[which]
    del which
    # the phase in cycles, its whole turns dropped: the carrier's exact
    # residue, then the running sum of the tones
    t = torch.arange(n, dtype=torch.int64, device=dev)
    cycles = torch.remainder(t * off, fsi).double() / fs
    del t, off
    cycles += float(config["deviation_hz"]) / fs * torch.cumsum(audio.double(), 0)
    del audio
    angle = (2 * math.pi * torch.frac(cycles)).float()
    del cycles
    gen = device_generator(seed, dev)
    iq = math.sqrt(float(traffic["noise_power"])) * torch.randn(
        n, dtype=torch.complex64, generator=gen, device=dev)
    iq += torch.polar(amp, angle)
    return {"iq": iq, "n": n,
            "truth": {"payloads": truth["payloads"], "starts": starts,
                      "ends": ends, "amplitudes": amps.tolist(),
                      "offsets_hz": offsets.tolist(),
                      "drifts": frame_drifts(traffic, seed).tolist()}}
