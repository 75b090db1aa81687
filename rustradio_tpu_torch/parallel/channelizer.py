"""Polyphase filterbank channelizer + per-channel FM bank (port of
``rustradio_tpu/parallel/channelizer.py``).

Channel k of ``pfb_channelize(x, taps, M)`` equals the DDC
``decimate_M(lowpass_h(x * exp(-2j pi k t / M)))`` with zero history:

    y_k[n] = sum_j h[j] * x[n*M - j] * exp(2j pi k j / M)

(the critically-sampled PFB identity).  On the card it is kernel H
(``ops.kernels.pfb_channelize``, ``csrc/pfb_channelize.cu``): one read of
the capture and one write of the channel matrix, the branch FIR and the
inverse DFT in between, and each channel's power summed beside the stores.
Its plain version, the form of the JAX package in torch ops (L row-shifted
multiply-adds over the (nframes, M) frame matrix, one batched inverse FFT),
runs on a CPU tensor; on the card a channel count or filter length the
kernel does not take raises.  The JAX package's MXU form of the inverse DFT
(``_idft_mxu``) is a TPU workaround and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from .mesh import gather_lines, on_device


def channelizer_taps(n_channels: int, taps_per_branch: int = 8,
                     atten_frac: float = 0.4) -> np.ndarray:
    """Prototype lowpass for an M-channel PFB: cutoff at atten_frac of the
    channel spacing, length M * taps_per_branch (windowed sinc at fs=1)."""
    ntaps = n_channels * taps_per_branch
    h = _windowed_sinc(ntaps, atten_frac / n_channels)
    return (h / h.sum()).astype(np.float32)


def _windowed_sinc(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(2 * cutoff * n)
    return (h * np.hamming(ntaps)).astype(np.float32)


def _complex_stream(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.complex64).contiguous()
    if device is None:
        raise ValueError("a numpy input needs device= (e.g. 'cuda' or 'cpu')")
    return torch.from_numpy(np.ascontiguousarray(x, np.complex64)).to(device)


def pfb_channelize(x, taps, n_channels: int, device=None) -> torch.Tensor:
    """Critically-sampled polyphase channelizer.

    Returns (nframes, n_channels) complex64 on ``x``'s device; channel k is
    centered at k * fs / M (wrapping to negative frequencies above M/2).
    ``x`` is a complex tensor, or numpy with ``device=``.  Kernel H on the
    card (``ops.kernels.pfb_channelize``, which says which shapes it takes).
    """
    return kernels.pfb_channelize(_complex_stream(x, device), taps, n_channels)


def pfb_channelize_power(x, taps, n_channels: int, device=None):
    """:func:`pfb_channelize` and each channel's mean power over the
    frames: ``(ch, power)``, power the (n_channels,) f32
    ``(ch.real ** 2 + ch.imag ** 2).mean(0)``, which kernel H sums beside
    its stores (no pass over ``ch``)."""
    return kernels.pfb_channelize(_complex_stream(x, device), taps, n_channels,
                                  power=True)


def channelizer_fm_bank(x, taps, n_channels: int, gain: float = 1.0,
                        device=None) -> torch.Tensor:
    """Wideband FM bank: channelize, then FM-demod every channel with the
    exact atan2.  Returns (nframes - 1, n_channels) float32."""
    ch = pfb_channelize(x, taps, n_channels, device)
    d = torch.conj(ch[:-1, :]) * ch[1:, :]
    return float(np.float32(gain)) * torch.atan2(d.imag, d.real)


def sharded_channelizer_fm(x, taps, n_channels: int, mesh, gain: float = 1.0,
                           axis: str = "chan") -> torch.Tensor:
    """Channel-sharded FM bank: on each line of the mesh along ``axis``
    (one line on a 1-D mesh; on a (chan, time) mesh one per time index,
    the front half replicated over ``time``) the PFB front half runs once
    on the line's first device; the channelized matrix's columns are
    split over the line's shards, each shard demodulates its channels on
    its device, and the (nframes - 1, n_channels) result of the line
    through the mesh's first device is gathered there."""
    n_sh = mesh.shape[axis]
    if n_channels % n_sh or mesh.world > 1:
        raise ValueError(f"{n_channels} channels over {n_sh} shards of one "
                         "process")
    w = n_channels // n_sh
    g = float(np.float32(gain))
    parts = [None] * mesh.local
    for line in mesh.lines(axis):
        d0 = mesh.devices[line.local[0]]
        ch = pfb_channelize(x.to(d0) if torch.is_tensor(x) else x, taps,
                            n_channels, d0)
        for j, k in zip(line.local, line.ks):
            dev = mesh.devices[j]
            block = ch[:, k * w:(k + 1) * w].to(dev)
            with on_device(dev):
                d = torch.conj(block[:-1]) * block[1:]
                parts[j] = g * torch.atan2(d.imag, d.real)
    return gather_lines(parts, mesh, axis, 1)
