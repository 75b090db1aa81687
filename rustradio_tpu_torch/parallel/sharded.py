"""Time- and channel-sharded stream ops (port of
``rustradio_tpu/parallel/sharded.py``).

Each function is semantically its offline counterpart in
:mod:`rustradio_tpu_torch.ops` applied to the *global* stream, executed
with the sample (or channel) axis sharded over a mesh: each shard runs the
port's own offline op (kernel A for the FIRs, kernels E/D for the clock
recovery, on the card), with the filter halos exchanged between
neighbouring shards (``halo``) instead of host-side state.

Each takes the global tensor (or numpy array) or this process's shards as
a list (one per mesh device), and returns the global output as one tensor
on the mesh's first device, the value of JAX's global array; in a mesh
across processes, this process's shards concatenated.  On a mesh of
several axes an op sharded over ``axis`` runs on every line of the mesh
along it (``Mesh.lines``), replicated along the other axes as
``shard_map(.., in_specs=P(axis))`` is, and returns the line through the
mesh's first device: the op on a 1-D mesh of ``mesh.shape[axis]`` shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fft_filter import fft_filter as _fft_filter
from ..ops.fir import fir_filter as _fir_filter
from .graph_mesh import shard_chain
from .halo import halo_exchange_left, halo_exchange_right
from .mesh import gather_lines, global_len, on_device, time_axis_spec


def _shards(x, mesh, axis: str, dtype=None) -> list[torch.Tensor]:
    if isinstance(x, (list, tuple)):
        shards = list(x)
    else:
        shards = time_axis_spec(mesh, axis).shard(x)
    return shards if dtype is None else [s.to(dtype) for s in shards]


def sharded_fir_filter(x, taps, mesh, deci: int = 1, axis: str = "time"):
    """fir_filter_full semantics (y[m] = sum_j taps[j] x[m*deci-j]) with the
    time axis sharded: each shard takes a left halo of ntaps-1 samples and
    runs the valid-mode FIR (kernel A on the card).  The global length must
    be divisible by shards*deci."""
    taps = np.asarray(taps)
    ntaps = len(taps)
    n_sh = mesh.shape[axis]
    n = global_len(x, mesh, axis)
    if n % (n_sh * deci):
        raise ValueError(f"stream length {n} not divisible by shards*deci")
    shards = _shards(x, mesh, axis)
    exts = halo_exchange_left(shards, ntaps - 1, mesh, axis)
    out = []
    for s, ext, d in zip(shards, exts, mesh.devices):
        with on_device(d):
            # y[m] = sum taps[j] ext[(ntaps-1) + m*deci - j]
            out.append(_fir_filter(ext, taps, deci)[: s.shape[0] // deci])
    return gather_lines(out, mesh, axis)


def sharded_fft_filter(x, taps, mesh, axis: str = "time",
                       fft_size: int | None = None):
    """Overlap-save FFT filter (``ops.fft_filter``) with the time axis
    sharded: a left halo of ntaps-1 samples, the halo's outputs dropped."""
    taps = np.asarray(taps)
    ntaps = len(taps)
    n_sh = mesh.shape[axis]
    n = global_len(x, mesh, axis)
    if n % n_sh:
        raise ValueError(f"stream length {n} not divisible by {n_sh} shards")
    shards = _shards(x, mesh, axis, torch.complex64)
    exts = halo_exchange_left(shards, ntaps - 1, mesh, axis)
    out = []
    for s, ext, d in zip(shards, exts, mesh.devices):
        with on_device(d):
            out.append(_fft_filter(ext, taps, fft_size)[ntaps - 1:][: s.shape[0]])
    return gather_lines(out, mesh, axis)


def sharded_quadrature_demod(x, gain, mesh, axis: str = "time"):
    """Quadrature demod over a sharded stream: a 1-sample right halo.

    Output has the same global length as the input; the final global sample
    is 0 (the offline op emits N-1 samples — callers drop the last one).
    """
    n_sh = mesh.shape[axis]
    n = global_len(x, mesh, axis)
    if n % n_sh:
        raise ValueError(f"stream length {n} not divisible by {n_sh} shards")
    shards = _shards(x, mesh, axis, torch.complex64)
    exts = halo_exchange_right(shards, 1, mesh, axis, fill=0)
    g = float(np.float32(gain))
    out = []
    for ext, dv in zip(exts, mesh.devices):
        with on_device(dv):
            d = torch.conj(ext[:-1]) * ext[1:]
            out.append(g * torch.atan2(d.imag, d.real))
    return gather_lines(out, mesh, axis)


def bell202_chain(samp_rate: float, band: tuple | None = (400.0, 2700.0)):
    """The blocks of the AX.25 1200 bd AFSK front-end (``models/ax25.py::
    bell202_demod``): band-pass -> Hilbert(65) -> quadrature demod ->
    1100 Hz low-pass -> centre offset (the reference chain,
    examples/ax25-1200-rx.rs:229-247, with the input band-pass)."""
    from .. import taps as tapgen
    from ..blocks.demod import QuadratureDemod
    from ..blocks.elementwise import AddConst
    from ..blocks.filters import FftFilterFloat, Hilbert

    lp = np.asarray(tapgen.low_pass(
        samp_rate, 1100.0, 200.0 if band is not None else 100.0, "hamming"))
    chain = []
    if band is not None:
        chain.append(FftFilterFloat(
            tapgen.band_pass(samp_rate, band[0], band[1], 65, "hamming")))
    chain += [
        Hilbert(65),
        QuadratureDemod(1.0),
        FftFilterFloat(lp),
        AddConst(-float(np.float32(2.0 * np.pi * 1700.0 / samp_rate))),
    ]
    return chain


def sharded_bell202_demod(audio, samp_rate: float, mesh, axis: str = "time",
                          band: tuple | None = (400.0, 2700.0)):
    """The full AX.25 1200 bd AFSK front-end (:func:`bell202_chain`),
    time-sharded in one shot.

    Thin wrapper: the body is built from the blocks' own shard plans via
    :func:`..parallel.graph_mesh.shard_chain`, so the halo widths are
    derived from what each block declares.  Output equals the offline
    chain (length N-1)."""
    if isinstance(audio, (list, tuple)):
        audio = [a.to(torch.float32) for a in audio]
    else:
        audio = torch.as_tensor(audio).to(torch.float32)
    return shard_chain(bell202_chain(samp_rate, band), mesh, axis)(audio)


def sharded_symbol_sync_bank(xs, sps: float, mesh, axis: str = "chan",
                             max_deviation: float = 0.5,
                             clock_taps=(0.5, 0.5), unroll: int = 16,
                             method: str = "scan",
                             max_events: int | None = None,
                             return_valid: bool = False):
    """Clock recovery for a (C, N) bank of NRZ streams with the CHANNEL
    axis sharded over the mesh.

    Each shard runs ``recover_symbols_batch`` over its C/n_shards channels
    (one kernel E launch for ``method="scan"``, one kernel D launch for
    ``"events"``, on the card): channels never talk to each other, so the
    shards need no halos.  Returns (values, mask, clocks), each (C, N);
    ``return_valid=True`` appends the per-channel budget-overflow flags
    (all True for the scan method) as a 4th output.
    """
    from ..models.multichannel import recover_symbols_batch

    n_sh = mesh.shape[axis]
    if method not in ("scan", "events"):
        raise ValueError(f"unknown method {method!r}; use 'scan' or 'events'")
    c = global_len(xs, mesh, axis)
    if c % n_sh:
        raise ValueError(f"channel count {c} must be divisible by {n_sh} shards")
    parts = []
    for s, d in zip(_shards(xs, mesh, axis, torch.float32), mesh.devices):
        with on_device(d):
            parts.append(recover_symbols_batch(
                s, sps, max_deviation, clock_taps, unroll=unroll, method=method,
                max_events=max_events, return_valid=True))
    vals, mask, clks, valid = (gather_lines(p, mesh, axis) for p in zip(*parts))
    if return_valid:
        return vals, mask, clks, valid
    return vals, mask, clks


def sharded_fm_demod(iq, taps, mesh, deci: int = 1, gain: float = 1.0,
                     axis: str = "time", fft_size: int | None = None):
    """The headline chain — channel low-pass + decimate + FM demod — with
    the time axis sharded, halos exchanged once per stream.

    Thin wrapper over :func:`..parallel.graph_mesh.shard_chain`: the body
    is built from FirFilter's and QuadratureDemod's own shard plans (kernel
    A once per shard on the card), so halo widths and decimation-grid
    alignment are derived, not hardcoded.  Output follows the blocks'
    valid-conv streaming alignment: it equals
    ``quadrature_demod(fir_filter(iq, taps, deci), gain)`` for every sample
    that chain defines (up to one trailing sample whose window touches the
    stream end may follow; slice to the offline length for exact
    comparison).  ``fft_size`` is accepted for the JAX signature."""
    from ..blocks.demod import QuadratureDemod
    from ..blocks.filters import FirFilter

    return shard_chain(
        [FirFilter(np.asarray(taps), deci), QuadratureDemod(gain)], mesh, axis
    )(iq)
