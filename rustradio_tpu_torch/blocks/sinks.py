"""Sink blocks (port of ``rustradio_tpu/blocks/sinks.py``: ``VectorSink``,
``NullSink``, ``DeviceFoldSink``, ``DebugSink``, ``FileSink``,
``DebugFilter``, ``PduVectorSink`` and ``PduFileSink``)."""

from __future__ import annotations

import numpy as np
import torch

from ..io import rawfile
from ..streams import Tag
from .base import Block


def _host(x) -> np.ndarray:
    """A chunk (a tensor on any device, or numpy) as host numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class VectorSink(Block):
    """Collects samples (copied to host numpy) + tags; the main test sink
    (reference src/vector_sink.rs:18-58)."""

    graph_capturable = False  # host: copies each chunk to numpy
    n_out = 0
    domain = "host"

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self._tags: list[Tag] = []

    def apply(self, x):
        self._chunks.append(x.cpu().numpy())
        return ()

    def accept_tags(self, tags: list[Tag], offset: int):
        self._tags.extend(Tag(t.pos + offset, t.key, t.val) for t in tags)

    def data(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0)
        return np.concatenate(self._chunks)

    def tags(self) -> list[Tag]:
        return sorted(self._tags)


class NullSink(Block):
    graph_capturable = False  # a sink
    n_out = 0
    domain = "host"

    def apply(self, x):
        return ()


class DeviceFoldSink(Block):
    """Device-side reducing sink for ``Graph.compile_device_loop``: folds
    every chunk into a carried 0-d tensor on the loop's device, so
    per-sample output never leaves the device inside the loop.  Default
    fold: running sum of the real part.

    Under the offline runner it accumulates the same reduction on the host
    (``total()``), so a graph using it stays runnable everywhere.
    """

    graph_capturable = False  # a sink (folds inside the device loop)
    n_out = 0
    domain = "host"

    def __init__(self, fn=None, init: float = 0.0):
        self._fn = fn
        self._init = float(init)
        self._total = float(init)

    # ---- device loop protocol ----
    def fold_init(self, device):
        # a fill on the device, not a host-to-device copy (which would
        # wait for the device before the loop starts)
        return torch.full((), self._init, dtype=torch.float32, device=device)

    def fold(self, carry, *xs):
        if self._fn is not None:
            return self._fn(carry, *xs)
        return carry + xs[0].real.float().sum()

    # ---- offline runner ----
    def apply(self, x):
        if self._fn is None:
            self._total += float(x.real.double().sum())
        return ()

    def total(self) -> float:
        return self._total


class PduVectorSink(Block):
    """Collects PDUs, the PDU-domain test sink."""

    graph_capturable = False  # host: PDUs
    n_out = 0
    domain = "host"

    def __init__(self):
        self._pdus = []

    def apply(self, pdus):
        self._pdus.extend(pdus)
        return ()

    def pdus(self):
        return list(self._pdus)


def _debug_print(x, limit: int, tag: str) -> None:
    arr = _host(x)
    for v in arr[:limit]:
        print(f"{tag}: {v}")
    if len(arr) > limit:
        print(f"{tag}: ... {len(arr) - limit} more")


class DebugSink(Block):
    """Prints samples (reference src/debug_sink.rs)."""

    graph_capturable = False  # host: prints
    n_out = 0
    domain = "host"

    def __init__(self, limit: int = 32):
        self.limit = limit

    def apply(self, x):
        _debug_print(x, self.limit, "debug")
        return ()


class FileSink(Block):
    """Raw sample file sink (reference src/file_sink.rs; Mode::{Create,
    Overwrite,Append} maps to 'xb'/'wb'/'ab')."""

    graph_capturable = False  # host: writes the file
    n_out = 0
    domain = "host"

    def __init__(self, path: str, mode: str = "overwrite"):
        self.path = path
        self.mode = {"create": "xb", "overwrite": "wb", "append": "ab"}[mode]
        self._first = True

    def apply(self, x):
        m = self.mode if self._first else "ab"
        rawfile.write_samples(self.path, _host(x), mode=m)
        self._first = False
        return ()


class DebugFilter(Block):
    """Pass-through that prints samples (reference src/debug_sink.rs
    DebugFilter): DebugSink in the middle of a chain."""

    graph_capturable = False  # host: prints
    domain = "host"

    def __init__(self, limit: int = 32, tag: str = "debug"):
        self.limit = limit
        self.tag = tag

    def apply(self, x):
        _debug_print(x, self.limit, self.tag)
        return x


class PduFileSink(Block):
    """Append every PDU's bytes to one file (reference src/file_sink.rs
    NoCopyFileSink :207); closed by ``finish()`` at the end of a run."""

    graph_capturable = False  # host: PDUs
    n_out = 0
    domain = "host"

    def __init__(self, path: str, mode: str = "overwrite"):
        modes = {"create": "xb", "overwrite": "wb", "append": "ab"}
        self._f = open(path, modes[mode])

    def apply(self, pdus):
        for p in pdus:
            self._f.write(np.asarray(_host(p.data), np.uint8).tobytes())
        self._f.flush()
        return ()

    def finish(self):
        self._f.close()
