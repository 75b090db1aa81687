"""FM receive chains (port of ``rustradio_tpu/models/fm.py``, the
reference's rtl_fm.rs example path).

Taps are the real part of ``low_pass_complex(samp_rate, cutoff, twidth,
"hamming")`` (49 taps at the defaults).  ``am_rx`` and ``wbfm_rx`` are the
AM and broadcast-FM receivers: their channel filters run on kernel A
through ``ops.filter_complex`` (and ``filter_float``), then plain torch.

Inputs: a tensor stays on its device; a numpy array goes to the ``device``
the caller names (there is no default device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import taps as tapgen
from ..ops import kernels
from ..ops.demod import quadrature_demod
from ..ops.fft_filter import filter_complex, filter_float
from ..ops.iir import single_pole_iir
from ..ops.resampler import rational_resampler


@functools.lru_cache(maxsize=16)
def _lp(samp_rate, cutoff, twidth) -> kernels.TapSet:
    """The channel low-pass of a rate triple, designed once."""
    return kernels.tapset(np.real(tapgen.low_pass_complex(
        samp_rate, cutoff, twidth, "hamming")))


def _on_device(x, dtype, device) -> torch.Tensor:
    """A tensor stays on its device; numpy goes to ``device``."""
    if torch.is_tensor(x):
        return x
    if device is None:
        raise ValueError("a numpy input needs device= (e.g. 'cuda' or 'cpu')")
    return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)


def fm_demod_chain(
    iq,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    gain: float = 1.0,
    device=None,
):
    """Complex IQ -> FM audio: channel low-pass + decimation (kernel A, the
    I and Q planes in one launch) + quadrature demod with the exact atan2.
    Output length ceil(N/deci) - 1, on ``iq``'s device (a numpy input goes
    to ``device``)."""
    x = _on_device(iq, np.complex64, device).to(torch.complex64)
    y = kernels.fir_decimate(x, _lp(samp_rate, cutoff, twidth), deci)
    return quadrature_demod(y, gain)


def fm_pack_planes(
    i,
    q,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    precision: str = "w3",
    device=None,
):
    """Ingest: flat f32 I/Q planes -> packed planes (``fm_plane_pack``) +
    the true sample count, on the planes' device (numpy planes go to
    ``device``).  Feed the result to :func:`fm_demod_chain_planar` with
    ``n=``."""
    taps = _lp(samp_rate, cutoff, twidth)
    i = _on_device(i, np.float32, device)
    q = _on_device(q, np.float32, device)
    return (
        kernels.fm_plane_pack(i, taps, deci, precision=precision),
        kernels.fm_plane_pack(q, taps, deci, precision=precision),
        i.shape[0],
    )


def fm_demod_chain_planar(
    i,
    q,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    gain: float = 1.0,
    precision: str = "highest",
    dc_offset: float = 0.0,
    n: int | None = None,
    device=None,
):
    """Planar-input FM chain as ONE kernel B pass (``kernels.fm_chain``).

    Flat f32 planes (numpy planes go to ``device``), or packed planes from
    :func:`fm_pack_planes` with the true sample count ``n=``.  For 8-bit-sourced data on the (u8-127)/128
    wire grid pass ``precision="w3"`` (bf16-exact planes) or ``"i8"``
    (int8 planes); any DC convention (e.g. (x-127.4)/128) rides
    ``dc_offset``, which folds in after the dot.
    """
    taps = _lp(samp_rate, cutoff, twidth)
    i = _on_device(i, np.float32, device)
    q = _on_device(q, np.float32, device)
    return kernels.fm_chain(i, q, taps, deci, gain, offset=dc_offset,
                            precision=precision, n=n)


def am_rx(iq, samp_rate: float, audio_rate: float = 48_000.0,
          volume: float = 1.0, device=None):
    """AM receiver (reference examples/airspy_am_decode.rs:48-83): 12.5 kHz
    channel filter -> envelope |x| -> audio low-pass -> resample to the
    audio rate -> volume.  On ``iq``'s device (numpy goes to ``device``)."""
    samp_rate, audio_rate = float(samp_rate), float(audio_rate)
    x = _on_device(iq, np.complex64, device).to(torch.complex64)
    lp = tapgen.low_pass_complex(samp_rate, 12_500.0, 10_000.0, "hamming")
    env = filter_complex(x, lp).abs()
    lp2 = tapgen.low_pass(samp_rate, audio_rate, 500.0, "hamming")
    audio = filter_float(env, lp2)
    audio = rational_resampler(audio, int(audio_rate), int(samp_rate))
    return audio * float(np.float32(volume))


def wbfm_rx(iq, samp_rate: float, audio_rate: float = 48_000.0,
            channel_width: float = 100_000.0, device=None):
    """Broadcast WBFM: channel filter, discriminator (75 kHz deviation),
    resample to the audio rate, 75 us de-emphasis (a single-pole IIR).  On
    ``iq``'s device (numpy goes to ``device``)."""
    samp_rate, audio_rate = float(samp_rate), float(audio_rate)
    x = _on_device(iq, np.complex64, device).to(torch.complex64)
    lp = tapgen.low_pass_complex(samp_rate, channel_width, channel_width / 4,
                                 "hamming")
    y = filter_complex(x, lp)
    demod = quadrature_demod(y, float(samp_rate / (2 * np.pi * 75_000.0)))
    audio = rational_resampler(demod, int(audio_rate), int(samp_rate))
    dt = 1.0 / audio_rate
    return single_pole_iir(audio, float(dt / (75e-6 + dt)))
