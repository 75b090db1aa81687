"""Demodulation and modulation blocks (port of
``rustradio_tpu/blocks/demod.py``: ``QuadratureDemod``, ``FastFM``,
``Vco``)."""

from __future__ import annotations

import torch

from ..ops.demod import fast_fm, quadrature_demod
from ..ops.vco import vco
from .base import Block


class QuadratureDemod(Block):
    """FM discriminator (reference src/quadrature_demod.rs:46-113).

    Offline: N-1 outputs.  Streaming: carries one sample, so after the
    first chunk every chunk yields len(x) outputs.
    """

    graph_capturable = True
    # mesh execution: 1-sample halo; the stream-start output the halo
    # form emits but streaming never does (arg(conj(0)*x0)) is dropped
    shard_halo = 1
    shard_extra_drop = 1

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def apply(self, x):
        return quadrature_demod(x, self.gain)

    def init_state(self):
        return torch.zeros(0, dtype=torch.complex64)

    def apply_chunk(self, state, x):
        # an empty carry (stream start) takes the chunk's device
        ext = x if state.numel() == 0 else torch.cat([state, x])
        return ext[-1:].clone(), quadrature_demod(ext, self.gain)


class FastFM(Block):
    """Lyons fast FM (reference src/quadrature_demod.rs:144-165); carries
    the last two samples (zeros at stream start)."""

    graph_capturable = True
    shard_halo = 2  # zero-history 2-sample lookback

    def apply(self, x):
        return fast_fm(x)

    def init_state(self):
        return torch.zeros(2, dtype=torch.complex64)

    def apply_chunk(self, state, x):
        ext = torch.cat([state.to(x.device), x.to(torch.complex64)])
        return ext[-2:].clone(), fast_fm(ext)[2:]


class Vco(Block):
    """FM modulator (reference src/vco.rs); carries its phase (a 0-d f32
    tensor after the first chunk)."""

    graph_capturable = True  # the phase is a 0-d tensor after the first chunk

    def __init__(self, k: float):
        self.k = k

    def apply(self, x):
        out, _ = vco(x, self.k)
        return out

    def init_state(self):
        return 0.0

    def apply_chunk(self, state, x):
        if x.shape[0] == 0:
            return state, x.new_zeros(0, dtype=torch.complex64)
        out, phase = vco(x, self.k, phase0=state)
        return phase, out
