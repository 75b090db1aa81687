"""Bit-level digital blocks: NRZI decode and clock recovery (port of
``NrziDecode`` and ``SymbolSync`` from ``rustradio_tpu/blocks/digital.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ops.nrzi import nrzi_decode
from ..ops.symbol_sync import (
    compact,
    default_max_events,
    recover_symbols,
    symbol_sync_events,
)
from .base import Block


class NrziDecode(Block):
    """NRZI-S decode (reference src/nrzi.rs:37-42); carries the previous
    bit (0 at stream start, a Python int or a 0-d tensor)."""

    def apply(self, x):
        return nrzi_decode(x)

    def init_state(self):
        return 0

    def apply_chunk(self, state, x):
        x = x.to(torch.uint8)
        y = nrzi_decode(x, last=int(state))
        # a data-dependent upstream (clock recovery) can emit an empty
        # chunk; keep the carried bit then
        return (state if x.shape[0] == 0 else x[-1:].clone()), y


class SymbolSync(Block):
    """Zero-crossing TED clock recovery (reference src/symbol_sync.rs).

    Output length is data-dependent, so this is a host-domain block.
    ``method``:

    * ``"native"`` (default) — the sequential per-sample recurrence on the
      host (native ``rr_symbol_sync``, bit-exact with the JAX package's
      scan); streaming carries its state dict (the scan's keys).
    * ``"events"`` — the event-driven device form
      (``ops.symbol_sync_events``, kernel D on the card), on the input's
      device; its symbols stay there.  Chunked output equals the block's
      own whole-stream output.  The event budget sizes itself from
      ``sps`` (pow-2 bucketed) and doubles on overflow up to the chunk
      length, the state untouched, so chattery input costs a larger
      budget, not wrong output.
    """

    domain = "host"

    def __init__(self, sps: float, max_deviation: float = 0.5,
                 clock_taps=(0.5, 0.5), method: str = "native",
                 max_events: int | None = None):
        if method not in ("native", "events"):
            raise ValueError(f"unknown method {method!r}; use 'native' or 'events'")
        self.sps = sps
        self.max_deviation = max_deviation
        self.clock_taps = tuple(clock_taps)
        self.method = method
        self.max_events = max_events

    def init_state(self):
        return {"sync": None}

    def _run_events(self, x: torch.Tensor, state):
        n = x.shape[0]
        if n == 0:
            return x.new_zeros(0, dtype=torch.float32), state
        budget = self.max_events or default_max_events(n, self.sps)
        while True:
            (vals, mask, _), valid, new_state = symbol_sync_events(
                x, self.sps, self.max_deviation, self.clock_taps,
                max_events=budget, state=state, return_state=True)
            if bool(valid) or budget >= n:
                break
            budget = min(n, budget * 2)  # overflow: retry, state untouched
        return compact(vals, mask), new_state

    def apply(self, x):
        if self.method == "events":
            return self._run_events(x, None)[0]
        return torch.from_numpy(recover_symbols(
            x, self.sps, self.max_deviation, self.clock_taps))

    def apply_chunk(self, state, x):
        prev = state["sync"] if state else None
        if self.method == "events":
            syms, new = self._run_events(x, prev)
            return {"sync": new}, syms
        vals, _, new = native.symbol_sync_f32_state(
            x.detach().cpu().numpy(), self.sps, self.max_deviation,
            np.asarray(self.clock_taps), state=prev)
        return {"sync": new}, torch.from_numpy(vals)
