"""The FM receive chain in plain PyTorch, and the check of the FM cells.

The chain is the configuration's: the real channel low-pass on the I and
Q planes with zero history, decimation, the exact discriminator
``gain * atan2(Im, Re)`` of ``conj(y[k-1]) * y[k]`` with ``gain =
samp_rate / (2 pi deviation_hz)``, then, where the cell resamples (its
driver's ``resample``), rustradio's rational resampler to ``audio_rate``
(no filter: output k is input floor(k * deci / interp) of the reduced
ratio, ``src/rational_resampler.rs``).  It runs in
float64 on the planes the program was handed (``fm_chain`` by default),
or in a lower precision as the control (``dtype=torch.bfloat16``:
planes, taps, filter and discriminator all in bfloat16).  Nothing here
comes from the program: the taps are designed by ``reference.taps``.

The check compares every output of the timed pass that the cell's
driver module kept with the float64 chain and reports the widest gap in
the discriminator's radians (the gap over the gain), wrapped to
(-pi, pi].
"""

from __future__ import annotations

import math

import torch

from . import taps as reftaps


def channel_taps(config: dict) -> torch.Tensor:
    """The configuration's channel filter as float64 taps (designed in
    f32, as rustradio does)."""
    lp = reftaps.low_pass(config["samp_rate"], config["cutoff_hz"],
                          config["twidth_hz"])
    return torch.from_numpy(lp).double()


def audio_gain(config: dict) -> float:
    return float(config["samp_rate"]) / (2 * math.pi * float(config["deviation_hz"]))


def resample_ratio(config: dict) -> tuple[int, int]:
    """(interp, deci) of the resampler, reduced."""
    interp, deci = int(config["audio_rate"]), int(config["samp_rate"])
    g = math.gcd(interp, deci)
    return interp // g, deci // g


def resample_index(n: int, interp: int, deci: int) -> torch.Tensor:
    """The input index of each of the ceil(n * interp / deci) outputs."""
    m = -(-n * interp // deci)
    return torch.arange(m, dtype=torch.int64) * deci // interp


def fir_deci(x: torch.Tensor, taps: torch.Tensor, deci: int) -> torch.Tensor:
    """y[m] = sum_j taps[j] x[m*deci - j], zero history: ceil(n/deci)
    outputs, in ``x``'s dtype."""
    w = taps.to(x.dtype).to(x.device).flip(0).view(1, 1, -1)
    xp = torch.nn.functional.pad(x.view(1, 1, -1), (len(taps) - 1, 0))
    return torch.nn.functional.conv1d(xp, w, stride=deci).view(-1)


def fm_chain(i: torch.Tensor, q: torch.Tensor, config: dict,
             dtype=torch.float64, resample: bool = True) -> torch.Tensor:
    """The chain over the planes ``i`` and ``q`` in ``dtype``: the
    ceil(n / deci) - 1 discriminator outputs, resampled to the audio
    where ``resample``, in float64 (the values of ``dtype``)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        taps = channel_taps(config)
        deci = int(config["deci"])
        yr = fir_deci(i.to(dtype), taps, deci)
        yi = fir_deci(q.to(dtype), taps, deci)
        re = yr[:-1] * yr[1:] + yi[:-1] * yi[1:]
        im = yr[:-1] * yi[1:] - yi[:-1] * yr[1:]
        del yr, yi
        demod = torch.atan2(im, re) * audio_gain(config)
        del re, im
        if not resample:
            return demod.double()
        idx = resample_index(demod.shape[0], *resample_ratio(config))
        return demod[idx.to(demod.device)].double()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def widest_gap_rad(got: torch.Tensor, want: torch.Tensor, gain: float) -> float:
    """max |got - want| / |gain|, wrapped to (-pi, pi]; 2 pi, more than
    any wrapped gap, where the program gave another number of outputs
    than the reference."""
    if got.shape != want.shape:
        return 2 * math.pi
    d = (got.to(want.device).double() - want) / abs(gain)
    d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def judge(run, window, dtype=torch.float64) -> list:
    """The FM check: the pass the cell's driver module kept
    (``window.outputs``: the program's ``audio`` and the planes it was
    made from, ``i`` and ``q``) against the chain in float64.  ``dtype``
    other than float64 puts the reference, in that precision, in the
    program's place (the control)."""
    from ..harness import Compared

    out = window.outputs
    resample = bool(run.args["resample"])
    want = fm_chain(out["i"], out["q"], run.config, resample=resample)
    got = out["audio"]
    if dtype != torch.float64:
        got = fm_chain(out["i"], out["q"], run.config, dtype, resample)
    gap = widest_gap_rad(got, want, audio_gain(run.config))
    return [Compared("max_err_rad", gap, run.limits["max_err_rad"])]
