"""Source blocks (port of ``rustradio_tpu/blocks/sources.py``:
``VectorSource``, ``ConstantSource``, ``SignalSourceComplex``,
``SignalSourceFloat``, ``NoiseSource``, ``FileSource`` and
``PackedIqRingSource``).  A source emits on the device its caller names;
``VectorSource`` keeps one copy of its data per device it has emitted on.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import rawfile
from ..ops import kernels
from ..ops.signal import signal_source_c, signal_source_f
from ..streams import Tag
from .base import SourceBlock


def _canonical(a: np.ndarray) -> np.ndarray:
    """Canonicalize to the framework's stream dtypes (Float=f32,
    Complex=c64, reference src/lib.rs:245-249)."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.complex128:
        return a.astype(np.complex64)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


_TORCH_CANON = {torch.float64: torch.float32, torch.complex128: torch.complex64,
                torch.int64: torch.int32}


class VectorSource(SourceBlock):
    """In-memory source with repeat + start/repeat/first tags
    (reference src/vector_source.rs:50-80).

    ``data`` is a numpy array or a tensor (kept on its device, and copied
    to another only when asked to emit there)."""

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, data, repeat: int = 1, tags: list[Tag] | None = None):
        self._resident: dict[str, torch.Tensor] = {}
        if torch.is_tensor(data):
            t = data.detach()
            t = t.to(_TORCH_CANON.get(t.dtype, t.dtype)).contiguous()
            self._resident[str(t.device)] = t
            self.data = t
        else:
            self.data = _canonical(np.asarray(data))
        self.repeat = repeat
        self.user_tags = list(tags or [])

    def total_len(self):
        return len(self.data) * self.repeat

    def emit_period(self):
        # the emit pattern repeats every len(data) samples
        return len(self.data)

    def _on(self, device) -> torch.Tensor:
        key = str(torch.device(device))
        t = self._resident.get(key)
        if t is None:
            src = (self.data if torch.is_tensor(self.data)
                   else torch.from_numpy(self.data))
            t = self._resident[key] = src.to(device)
        return t

    def emit(self, offset, n, device):
        if offset + n > self.total_len():
            raise ValueError("emit past end of VectorSource")
        data = self._on(device)
        m = len(self.data)
        start = offset % m
        if start + n <= m:
            return data[start : start + n]
        return data[torch.arange(offset, offset + n, device=data.device) % m]

    def emit_batch(self, offset, chunk_size, nb, device):
        """``nb`` chunks from ``offset`` as one (nb, chunk) tensor: a view
        of the resident data where the batch lies inside one period."""
        data = self._on(device)
        start = offset % len(self.data)
        if offset + nb * chunk_size > self.total_len():
            raise ValueError("emit past end of VectorSource")
        if start + nb * chunk_size <= len(self.data):
            return data[start : start + nb * chunk_size].view(nb, chunk_size)
        return self.emit(offset, nb * chunk_size, device).view(nb, chunk_size)

    def emit_tags(self, offset, n):
        out = []
        m = len(self.data)
        for rep in range(self.repeat):
            p = rep * m
            if offset <= p < offset + n:
                q = p - offset
                out.append(Tag(q, "VectorSource::start", True))
                out.append(Tag(q, "VectorSource::repeat", rep))
                if rep == 0:
                    out.append(Tag(q, "VectorSource::first", True))
        for t in self.user_tags:
            if offset <= t.pos < offset + n:
                out.append(Tag(t.pos - offset, t.key, t.val))
        return out


class ConstantSource(SourceBlock):
    """Constant generator; unbounded unless ``n`` is given (reference
    src/constant_source.rs)."""

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, value, n: int | None = None):
        self.value = value
        self.n = n
        self._dtype = torch.from_numpy(_canonical(np.full(1, value))).dtype

    def total_len(self):
        return self.n

    def emit(self, offset, n, device):
        return torch.full((n,), self.value, dtype=self._dtype, device=device)


class SignalSourceComplex(SourceBlock):
    """Complex sine (reference src/signal_source.rs:21-62), made on the
    run's device (``ops.signal_source_c``)."""

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, samp_rate, freq, amplitude=1.0, n: int | None = None):
        self.samp_rate, self.freq, self.amplitude, self.n = (
            samp_rate, freq, amplitude, n)

    def total_len(self):
        return self.n

    def emit(self, offset, n, device):
        return signal_source_c(n, self.samp_rate, self.freq, self.amplitude,
                               offset, device=device)


class SignalSourceFloat(SourceBlock):
    """Real sine, made on the run's device (``ops.signal_source_f``)."""

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, samp_rate, freq, amplitude=1.0, n: int | None = None):
        self.samp_rate, self.freq, self.amplitude, self.n = (
            samp_rate, freq, amplitude, n)

    def total_len(self):
        return self.n

    def emit(self, offset, n, device):
        return signal_source_f(n, self.samp_rate, self.freq, self.amplitude,
                               offset, device=device)


class NoiseSource(SourceBlock):
    """Gaussian noise (no reference equivalent; handy for tests): the JAX
    package's numpy stream, ``RandomState(seed + offset % 2^31)`` per
    emit, bit for bit, then moved to the run's device."""

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, scale=1.0, seed=0, n: int | None = None, complex=False):
        self.scale, self.seed, self.n, self.complex = scale, seed, n, complex

    def total_len(self):
        return self.n

    def emit(self, offset, n, device):
        rng = np.random.RandomState(self.seed + offset % (2**31))
        if self.complex:
            x = ((rng.randn(n) + 1j * rng.randn(n)) * self.scale).astype(np.complex64)
        else:
            x = (rng.randn(n) * self.scale).astype(np.float32)
        return torch.from_numpy(x).to(device)


class FileSource(SourceBlock):
    """Raw sample file source (reference src/file_source.rs): ``emit``
    seeks and reads only the requested window, so files larger than RAM
    stream; ``repeat`` replays the file.  Host domain: the samples are
    read on the host and moved to the run's device."""

    graph_capturable = False  # a source: reads the file
    domain = "host"

    def __init__(self, path: str, dtype="c32", repeat: int = 1):
        self.path, self.dtype, self.repeat = path, dtype, repeat
        self._dt = rawfile._resolve(dtype).newbyteorder("<")
        self._f = None
        self._file_samples = None

    def _open(self):
        if self._f is None:
            self._f = open(self.path, "rb")
            self._file_samples = os.path.getsize(self.path) // self._dt.itemsize
            if self._file_samples == 0:
                raise ValueError(f"{self.path}: no complete samples")
        return self._f

    def total_len(self):
        self._open()
        return self._file_samples * self.repeat

    def emit(self, offset, n, device):
        f = self._open()
        m = self._file_samples
        out = np.empty(n, self._dt)
        got = 0
        while got < n:
            pos = (offset + got) % m
            k = min(n - got, m - pos)
            f.seek(pos * self._dt.itemsize)
            buf = f.read(k * self._dt.itemsize)
            out[got : got + k] = np.frombuffer(buf, dtype=self._dt, count=k)
            got += k
        return torch.from_numpy(_canonical(out.astype(out.dtype.newbyteorder("=")))
                                ).to(device)


class PackedIqRingSource(SourceBlock):
    """Zero-copy ingest ring for the lowered FM chain.

    Holds I/Q planes packed ONCE per device (``kernels.fm_plane_pack``, the
    format a receiver's u8-normalize ingest pass writes) and emits
    :class:`lowering.PackedIqChunk` views: the resident planes plus a row
    offset.  Downstream FirFilter -> QuadratureDemod lowers to
    ``kernels.fm_chain_window``, which reads the ring in place.  Emits wrap
    modularly, replaying the ring; as in the JAX package the ring's
    trailing halo is zeros, so the last window of each pass reads padding.

    Requirements: (len(taps)-1) % deci == 0 (valid and full-conv grids
    coincide), chunk % (deci*128*tile_rows) == 0, ring length a multiple
    of the chunk.
    """

    graph_capturable = False  # a source: emits outside the graphs

    def __init__(self, i_plane, q_plane, taps, deci: int,
                 precision: str = "w3", tile_rows: int = 1024):
        self.i_plane = torch.as_tensor(i_plane, dtype=torch.float32)
        self.q_plane = torch.as_tensor(q_plane, dtype=torch.float32)
        if self.i_plane.shape != self.q_plane.shape:
            raise ValueError("I/Q planes differ in length")
        self.taps = np.asarray(taps, np.float32)
        if (len(self.taps) - 1) % deci:
            raise ValueError("packed ring needs (ntaps-1) % deci == 0")
        self.deci = int(deci)
        self.precision = precision
        kernels.plane_dtype(precision)
        self.geo = kernels.fm_pack_geometry(len(self.i_plane), self.taps,
                                            self.deci, tile_rows)
        self.tile_rows = self.geo.tile_rows
        if len(self.i_plane) % (self.geo.step * self.tile_rows):
            raise ValueError("ring length must divide deci*128*tile_rows")
        self._packed: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def emit_period(self):
        return len(self.i_plane)

    def packed(self, device):
        """The ring's packed (I, Q) planes on ``device``, packed on first use."""
        key = str(torch.device(device))
        if key not in self._packed:
            self._packed[key] = tuple(
                kernels.fm_plane_pack(p.to(device), self.taps, self.deci,
                                      self.tile_rows, self.precision)
                for p in (self.i_plane, self.q_plane))
        return self._packed[key]

    def emit(self, offset, n, device):
        from ..lowering import PackedIqChunk

        step = self.geo.step
        if n % (step * self.tile_rows):
            raise ValueError("chunk must divide deci*128*tile_rows")
        if len(self.i_plane) % n:
            raise ValueError("ring length must be a multiple of the chunk")
        pr, pi = self.packed(device)
        row0 = (offset // step) % (self.geo.g * self.tile_rows)
        return PackedIqChunk(pr, pi, row0, self.deci, self.tile_rows,
                             n // (step * self.tile_rows), len(self.taps))
