"""Source blocks (port of ``VectorSource`` and ``PackedIqRingSource`` from
``rustradio_tpu/blocks/sources.py``).  A source emits on the device its
caller names; it keeps one copy of its data per device it has emitted on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
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
