"""Filter blocks with exact streaming state carry (port of ``FirFilter``
from ``rustradio_tpu/blocks/filters.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.fir import fir_filter
from .base import Block


class FirFilter(Block):
    """Decimating FIR, valid-conv alignment (reference src/fir.rs:485-547).

    Streaming: carries unconsumed raw input, so chunked == offline exactly.
    ``precision`` is the kernel-B mode used when the graph lowering fuses
    this filter with a following QuadratureDemod ("w3"/"i8" are exact only
    for 8-bit-sourced wire grids); the unfused path always runs true f32.
    Frequency translation comes in a later slice.
    """

    def __init__(self, taps, deci: int = 1, precision: str = "highest"):
        self.taps = np.asarray(taps)
        self.deci = deci
        kernels.plane_dtype(precision)
        self.precision = precision
        # real taps: the record the kernels' wrappers derive everything
        # from, made once (complex taps are split per call)
        self._taps = (self.taps if np.iscomplexobj(self.taps)
                      else kernels.tapset(self.taps))

    def apply(self, x):
        return fir_filter(x, self._taps, self.deci)

    def init_state(self):
        return {"buf": torch.zeros(0), "out_off": 0}

    def apply_chunk(self, state, x):
        # an empty carry (stream start) takes the chunk's device and dtype
        buf = state["buf"]
        buf = x if buf.numel() == 0 else torch.cat([buf.to(x.dtype), x])
        out_off = state["out_off"]
        if buf.shape[0] < len(self.taps):
            return {"buf": buf, "out_off": out_off}, buf.new_zeros(0)
        n_out = (buf.shape[0] - len(self.taps)) // self.deci + 1
        y = fir_filter(buf, self._taps, self.deci)
        return {"buf": buf[n_out * self.deci :].clone(),
                "out_off": out_off + n_out}, y
