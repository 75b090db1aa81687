"""Sink blocks (port of ``VectorSink``, ``NullSink``, ``DeviceFoldSink`` and
``PduVectorSink`` from ``rustradio_tpu/blocks/sinks.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..streams import Tag
from .base import Block


class VectorSink(Block):
    """Collects samples (copied to host numpy) + tags; the main test sink
    (reference src/vector_sink.rs:18-58)."""

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

    n_out = 0
    domain = "host"

    def __init__(self):
        self._pdus = []

    def apply(self, pdus):
        self._pdus.extend(pdus)
        return ()

    def pdus(self):
        return list(self._pdus)
