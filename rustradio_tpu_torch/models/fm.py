"""FM receive chains (port of ``rustradio_tpu/models/fm.py``, the
reference's rtl_fm.rs example path).

Taps are the real part of ``low_pass_complex(samp_rate, cutoff, twidth,
"hamming")`` (49 taps at the defaults).  ``am_rx`` and ``wbfm_rx`` come in
a later slice, with the resampler and FFT filter they need.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import taps as tapgen
from ..ops import kernels
from ..ops.demod import quadrature_demod


def _lp(samp_rate, cutoff, twidth) -> np.ndarray:
    return np.asarray(tapgen.low_pass_complex(samp_rate, cutoff, twidth,
                                              "hamming"))


def fm_demod_chain(
    iq,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    gain: float = 1.0,
):
    """Complex IQ -> FM audio: channel low-pass + decimation (kernel A, two
    real launches) + quadrature demod with the exact atan2.  Output length
    ceil(N/deci) - 1, on ``iq``'s device (numpy input runs on the CPU)."""
    x = torch.as_tensor(iq).to(torch.complex64)
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
):
    """Ingest: flat f32 I/Q planes -> packed planes (``fm_plane_pack``) +
    the true sample count.  Feed the result to
    :func:`fm_demod_chain_planar` with ``n=``."""
    taps = np.real(_lp(samp_rate, cutoff, twidth))
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
):
    """Planar-input FM chain as ONE kernel B pass (``kernels.fm_chain``).

    Flat f32 planes, or packed planes from :func:`fm_pack_planes` with the
    true sample count ``n=``.  For 8-bit-sourced data on the (u8-127)/128
    wire grid pass ``precision="w3"`` (bf16-exact planes) or ``"i8"``
    (int8 planes); any DC convention (e.g. (x-127.4)/128) rides
    ``dc_offset``, which folds in after the dot.
    """
    taps = np.real(_lp(samp_rate, cutoff, twidth))
    return kernels.fm_chain(i, q, taps, deci, gain, offset=dc_offset,
                            precision=precision, n=n)
