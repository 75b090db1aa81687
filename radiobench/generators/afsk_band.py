"""A band of 1200 bd Bell 202 AX.25 stations as an rtl-sdr hears it:
complex64 I/Q at the configuration's rate, each station a narrowband FM
carrier on its channel of the configuration's grid, keyed only while it
sends, over a complex white noise floor that covers the whole band.

Each station's frames are made by ``afsk_frames``, one station a call at
the capture's rate: its Bell 202 audio (amplitude 1, no noise), its
payloads framed by ``reference.hdlc``, its exponential gaps and the
traffic's clock drifts, from a seed of its own.  The audio then frequency
modulates the station's carrier at the configuration's ``deviation_hz``,
from each burst's first sample (its lead of unmodulated carrier) to its
last.  The carrier rises over the burst's first ``ramp_samples`` and
falls over its last as a raised cosine, as a transmitter's power does
when it keys: a carrier switched on in one sample would splatter across
its neighbours' channels.  The carrier sits ``offsets_hz`` off the
channel's centre, at a carrier-to-noise ratio ``cnr_db`` in one channel
(``samp_rate / n_channels`` Hz); both sets are permuted by the seed, one
value a station.  So every seed makes the same amount of work, in
another order.

The carrier's phase is counted exactly (the carrier's whole Hz times the
sample index, modulo the whole sample rate) and the modulation's phase is
the running sum of the audio in float64."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import SEED_MASK, afsk_frames, device_generator, rng


def channels(config: dict) -> list[int]:
    """The channel of each of ``stations_hz``, on the grid of
    ``n_channels`` channels centred on ``center_hz`` (channel k at k *
    samp_rate / n_channels, above n_channels / 2 counted from the top)."""
    fs, m = float(config["samp_rate"]), int(config["n_channels"])
    out = []
    for f in config["stations_hz"]:
        k = (float(f) - float(config["center_hz"])) / (fs / m)
        if k != round(k):
            raise ValueError(f"station {f} Hz is not on a channel centre")
        out.append(int(round(k)) % m)
    return out


def station_seed(seed: int, station: int) -> int:
    return (seed * 8 + station + 1) & SEED_MASK


def envelope(starts, stops, ramp: int, n: int, device) -> torch.Tensor:
    """The carrier's envelope over n samples (f32): 1 inside each burst
    [start, stop), rising from 0 over its first ``ramp`` samples and
    falling over its last as a raised cosine, 0 between the bursts."""
    dev = torch.device(device)
    first = torch.from_numpy(np.asarray(starts, np.int64)).to(dev, torch.int32)
    last = torch.from_numpy(np.asarray(stops, np.int64)).to(dev, torch.int32) - 1
    # each sample's burst, counted from 1 (0 between the bursts)
    edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    number = torch.arange(1, len(first) + 1, dtype=torch.int32, device=dev)
    edge[first.long()] += number
    edge[last.long() + 1] -= number
    which = torch.cumsum(edge, 0, dtype=torch.int32)[:n].long()
    del edge
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    t = torch.arange(n, dtype=torch.int32, device=dev)
    # the distance to the burst's nearer end, in samples
    near = torch.minimum(t - torch.cat([zero, first])[which],
                         torch.cat([zero, last])[which] - t)
    del t
    w = torch.clamp((near + 1).float() / ramp, max=1.0)
    del near
    return (0.5 - 0.5 * torch.cos(math.pi * w)) * (which > 0)


def make(traffic: dict, config: dict, seed: int, device) -> dict:
    """The capture, ``iq`` (complex64, ``traffic["samples"]`` on
    ``device``), and what was sent: ``truth`` = {"frames": [(channel,
    payload)] station by station, each station's frames in capture order;
    "channels", "cnr_db", "offsets_hz": one entry a station}."""
    fs, m = float(config["samp_rate"]), int(config["n_channels"])
    if fs != int(fs):
        raise ValueError("afsk_band needs a whole sample rate")
    fsi, n = int(fs), int(traffic["samples"])
    chans = channels(config)
    ns = len(chans)
    r = rng(seed)
    cnr = np.asarray(traffic["cnr_db"], np.float64)[r.permutation(ns)]
    offsets = np.asarray(traffic["offsets_hz"], np.int64)[r.permutation(ns)]
    if len(cnr) != ns or len(offsets) != ns:
        raise ValueError("cnr_db and offsets_hz need one value a station")
    dev = torch.device(device)
    sigma = float(traffic["noise_rms"])
    iq = sigma * torch.randn(n, dtype=torch.complex64,
                             generator=device_generator(seed, dev), device=dev)
    one_station = {k: traffic[k] for k in (
        "drifts", "payload_bytes", "gap_law", "lead_samples", "sync_flags")}
    one_station.update(samples=n, frames=int(traffic["frames_per_station"]),
                       amplitudes=[1.0], noises=[0.0])
    audio_config = {k: config[k] for k in ("samp_rate", "baud", "mark_hz",
                                           "space_hz")}
    k_dev = float(config["deviation_hz"]) / fs  # cycles a sample at audio 1
    lead, ramp = int(traffic["lead_samples"]), int(traffic["ramp_samples"])
    if not 0 < ramp <= lead:
        raise ValueError("the carrier's ramp has to lie in its lead")
    t = torch.arange(n, dtype=torch.int64, device=dev)
    frames = []
    for s, k in enumerate(chans):
        sent = afsk_frames.make(one_station, audio_config,
                                station_seed(seed, s), dev)
        frames += [(k, p) for p in sent["truth"]["payloads"]]
        audio = sent.pop("audio")
        # the phase in cycles, its whole turns dropped: the carrier's exact
        # residue, then the running sum of the audio
        carrier = (k if k < m / 2 else k - m) * (fsi // m) + int(offsets[s])
        cycles = torch.remainder(t * carrier, fsi).double() / fs
        cycles += k_dev * torch.cumsum(audio.double(), 0)
        del audio
        angle = (2 * math.pi * torch.frac(cycles)).float()
        del cycles
        amp = sigma * math.sqrt(10.0 ** (cnr[s] / 10.0) / m)
        env = envelope(sent["truth"]["starts"], sent["truth"]["ends"] + 1 + lead,
                       ramp, n, dev)
        iq += torch.polar(amp * env, angle)
        del angle, env
    if len({p for _, p in frames}) != len(frames):
        raise ValueError("two stations drew the same payload")
    return {"iq": iq, "n": n,
            "truth": {"frames": frames, "channels": chans,
                      "cnr_db": cnr.tolist(), "offsets_hz": offsets.tolist()}}
