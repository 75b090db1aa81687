"""Filter blocks with exact streaming state carry (port of ``FirFilter``,
``FftFilter``, ``FftFilterFloat``, ``Hilbert``, ``SinglePoleIirFilter`` and
``IqBalance`` from ``rustradio_tpu/blocks/filters.py``).

Each streaming state lives on the stream's device: an initial state made
on the host moves to the chunk's device at the first chunk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import taps as tapgen
from ..ops import kernels
from ..ops.fft_filter import filter_complex, filter_float
from ..ops.fir import fir_filter, fir_filter_translating
from ..ops.hilbert import hilbert_transform
from ..ops.iir import single_pole_iir
from .base import Block, ShardFn


class FirFilter(Block):
    """Decimating FIR, valid-conv alignment (reference src/fir.rs:485-547).

    Streaming: carries unconsumed raw input, so chunked == offline exactly.
    ``translate=(samp_rate, freq)`` mixes the input by ``-freq`` while
    filtering (reference src/fir.rs:413-483, ``ops.fir_filter_translating``).
    ``precision`` is the kernel-B mode used when the graph lowering fuses
    this filter with a following QuadratureDemod ("w3"/"i8" are exact only
    for 8-bit-sourced wire grids); the unfused path always runs true f32.
    Capturable into a CUDA graph without ``translate`` (whose rotator phase
    is computed on the host from the carried output count).
    """

    graph_capturable = True

    def __init__(self, taps, deci: int = 1,
                 translate: tuple[float, float] | None = None,
                 precision: str = "highest"):
        self.taps = np.asarray(taps)
        self.deci = deci
        self.translate = translate
        self.graph_capturable = translate is None
        kernels.plane_dtype(precision)
        self.precision = precision
        # real taps: the record the kernels' wrappers derive everything
        # from, made once (complex taps are split per call)
        self._taps = (self.taps if np.iscomplexobj(self.taps)
                      else kernels.tapset(self.taps))

    def apply(self, x):
        if self.translate is not None:
            sr, fq = self.translate
            return fir_filter_translating(x, self.taps, sr, fq, self.deci)
        return fir_filter(x, self._taps, self.deci)

    def shard_fn(self, di):
        """Mesh plan: valid-conv windows realigned to the global stream.

        With ``di`` zero samples prepended at stream start, the streaming
        output grid (windows starting at multiples of ``deci`` in true
        stream coordinates) sits at mesh positions ``≡ di (mod deci)``;
        ``q0`` places the halo-extended window on that grid and the
        first ``(di + ntaps - 1) // deci`` outputs (windows touching the
        zero prefix) are masked by the runner."""
        ntaps, d = len(self.taps), self.deci
        h = ntaps - 1
        q0 = (di + h) % d

        if self.translate is not None:
            sr, fq = self.translate
            step = 2.0 * np.pi * float(fq) / float(sr)
            taps = self.taps

            def prep(in0: int) -> float:
                # fir_filter_translating on the local window phases its
                # rotator for the window END at local index ntaps-1 +
                # deci*p; the true stream window end is in0 + k*L + q0 +
                # deci*p - di + ntaps - 1, so the correction phase is
                # -step*(in0 + k*L + q0 - di - (ntaps-1)).  This is the
                # chunk part, reduced mod 2π in float64.
                return float(np.mod(-step * (in0 + q0 - di - h), 2.0 * np.pi))

            def fn(ext, n_local, ctx):
                y = fir_filter_translating(ext[q0:], taps, sr, fq, d)
                y = y[: n_local // d]
                # the shard's part, k * (-step * L), added in float64 (the
                # shard index is a host int here) and reduced mod 2π
                phase = np.mod(ctx.aux + ctx.k * math.fmod(-step * n_local,
                                                           2.0 * math.pi),
                               2.0 * np.pi)
                return y * complex(np.exp(1j * np.float32(phase)).astype(np.complex64))
        else:
            prep = None
            taps = self._taps

            def fn(ext, n_local, ctx):
                return fir_filter(ext[q0:], taps, d)[: n_local // d]

        return ShardFn(halo=h, d_out=(di + h) // d, div=d, fn=fn, prep=prep)

    def shard_total_out(self, n):
        return max(0, (n - len(self.taps)) // self.deci + 1)

    def shard_state(self, tail, consumed):
        """apply_chunk's state (unconsumed raw buffer + output offset)
        after ``consumed`` samples: emitted windows cover w*deci inputs."""
        w = self.shard_total_out(consumed)
        buf_len = consumed - w * self.deci
        h = len(self.taps) - 1
        buf = tail[h - buf_len:].clone() if buf_len else torch.zeros(0)
        return {"buf": buf, "out_off": w}

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
        if self.translate is not None:
            sr, fq = self.translate
            y = fir_filter_translating(buf, self.taps, sr, fq, self.deci)
            # the rotator's phase at this chunk's first global output, mod
            # 2*pi in float64 on the host (the raw product overflows f32)
            ph = np.mod(-2.0 * np.pi * fq / sr * self.deci * out_off, 2.0 * np.pi)
            y = y * complex(np.exp(1j * np.float32(ph)).astype(np.complex64))
        else:
            y = fir_filter(buf, self._taps, self.deci)
        return {"buf": buf[n_out * self.deci :].clone(),
                "out_off": out_off + n_out}, y


def _tail(ext: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` samples of ``ext`` (none for k == 0)."""
    return ext[ext.shape[0] - k :].clone()


class FftFilter(Block):
    """Fast-convolution filter, full-conv alignment (reference
    src/fft_filter.rs:289-354): ``ops.filter_complex``, kernel A for real
    taps up to ``kernels.MAX_TAPS``, overlap-save otherwise.  Streaming
    state: the last ntaps-1 inputs.  Capturable into a CUDA graph on kernel
    A (overlap-save uploads the tap spectrum per call)."""

    graph_capturable = True

    def __init__(self, taps, fft_size: int | None = None):
        self.taps = np.asarray(taps)
        self.fft_size = fft_size
        self.graph_capturable = bool(len(self.taps) <= kernels.MAX_TAPS
                                     and not np.any(np.imag(self.taps)))

    @property
    def shard_halo(self):
        return len(self.taps) - 1  # zero-history full conv: state == tail

    def apply(self, x):
        return filter_complex(x, self.taps, self.fft_size)

    def init_state(self):
        return torch.zeros(len(self.taps) - 1, dtype=torch.complex64)

    def apply_chunk(self, state, x):
        k = len(self.taps) - 1
        ext = torch.cat([state.to(x.device, torch.complex64),
                         x.to(torch.complex64)])
        y = filter_complex(ext, self.taps, self.fft_size)[k:]
        return _tail(ext, k), y


class FftFilterFloat(Block):
    """Float fast-convolution (reference src/fft_filter.rs:357-491):
    ``ops.filter_float``, kernel A up to ``kernels.MAX_TAPS`` taps.
    Streaming state: the last ntaps-1 inputs.  Capturable into a CUDA
    graph on kernel A (overlap-save uploads the tap spectrum per call)."""

    graph_capturable = True

    def __init__(self, taps, fft_size: int | None = None):
        self.taps = np.asarray(taps, np.float32)
        self.fft_size = fft_size
        self.graph_capturable = len(self.taps) <= kernels.MAX_TAPS
        self._taps = (kernels.tapset(self.taps)
                      if len(self.taps) <= kernels.MAX_TAPS else self.taps)

    @property
    def shard_halo(self):
        return len(self.taps) - 1  # zero-history full conv: state == tail

    def apply(self, x):
        return filter_float(x, self._taps, self.fft_size)

    def init_state(self):
        return torch.zeros(len(self.taps) - 1, dtype=torch.float32)

    def apply_chunk(self, state, x):
        k = len(self.taps) - 1
        ext = torch.cat([state.to(x.device, torch.float32), x.to(torch.float32)])
        y = filter_float(ext, self._taps, self.fft_size)[k:]
        return _tail(ext, k), y


class Hilbert(Block):
    """Hilbert transformer (reference src/hilbert.rs:68-125): float stream
    -> analytic complex64 stream, ``ops.hilbert_transform`` (its FIR on
    kernel A).  Streaming state: the last ntaps inputs, as the reference
    keeps; chunked output is the offline stream."""

    graph_capturable = True

    def __init__(self, ntaps: int = 65, window: str = "hamming"):
        if ntaps % 2 != 1:
            raise ValueError("hilbert filter len must be odd")
        self.ntaps = ntaps
        self.taps = kernels.tapset(tapgen.hilbert(ntaps, window))

    @property
    def shard_halo(self):
        return self.ntaps  # the reference keeps ntaps history (src/hilbert.rs)

    def apply(self, x):
        return hilbert_transform(x, self.ntaps, taps=self.taps)

    def init_state(self):
        return torch.zeros(self.ntaps, dtype=torch.float32)

    def apply_chunk(self, state, x):
        x = x.to(torch.float32)
        ext = torch.cat([state.to(x.device), x])
        n, k = x.shape[0], self.ntaps
        # y_im[i] = sum_j taps[j] x[i-1-j]: the full convolution of ext
        # read from position k-1 on
        y_im = kernels.fir_decimate(ext, self.taps, 1)[k - 1 : k - 1 + n]
        d = k - k // 2
        y_re = ext[k - d : k - d + n]
        return _tail(ext, k), torch.complex(y_re, y_im)


class SinglePoleIirFilter(Block):
    """y += alpha (x - y) (reference src/single_pole_iir_filter.rs), on
    ``ops.single_pole_iir``; carries the last output y0 (None at stream
    start)."""

    graph_capturable = False  # uploads its block matrix from numpy per call

    def __init__(self, alpha: float):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha out of range")
        self.alpha = alpha

    def apply(self, x):
        return single_pole_iir(x, self.alpha)

    def init_state(self):
        return None

    def apply_chunk(self, state, x):
        if x.shape[0] == 0:
            return state, single_pole_iir(x, self.alpha)
        y = single_pole_iir(x, self.alpha, y0=state)
        return y[-1].clone(), y


class IqBalance(Block):
    """DC offset removal: out = x - running_mean(x)
    (reference src/iq_balance.rs:50-78: mean = mean*(1-a) + x*a,
    out = x - mean); carries the running mean."""

    graph_capturable = False  # uploads its block matrix from numpy per call

    def __init__(self, alpha: float | None = None,
                 sample_rate: float | None = None, tau: float = 0.2):
        if alpha is None:
            if sample_rate is None:
                raise ValueError("need alpha or sample_rate")
            alpha = float(np.clip(1.0 - np.exp(-1.0 / (tau * sample_rate)),
                                  0.0, 1.0))
        self.alpha = float(np.clip(alpha, 0.0, 1.0))

    def apply(self, x):
        return x - single_pole_iir(x, self.alpha)

    def init_state(self):
        return None

    def apply_chunk(self, state, x):
        if x.shape[0] == 0:
            return state, x
        m = single_pole_iir(x, self.alpha, y0=state)
        return m[-1].clone(), x - m
