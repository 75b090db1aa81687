"""FM receive chains (port of ``rustradio_tpu/models/fm.py``, the
reference's rtl_fm.rs example path).

Taps are the real part of ``low_pass_complex(samp_rate, cutoff, twidth,
"hamming")`` (49 taps at the defaults).  ``am_rx`` and ``wbfm_rx`` come in
a later slice, with the resampler and FFT filter they need.

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
