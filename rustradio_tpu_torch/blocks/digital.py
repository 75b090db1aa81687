"""Bit-level digital blocks: NRZI, G3RUH scrambling, access-code
correlation and clock recovery (port of ``rustradio_tpu/blocks/digital.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ops.correlate import correlate_access_code
from ..ops.nrzi import nrzi_decode, nrzi_encode
from ..ops.scramble import descramble, scramble
from ..ops.symbol_sync import (
    compact,
    default_max_events,
    recover_symbols,
    symbol_sync_events,
)
from ..streams import Tag
from .base import Block, ShardFn


class NrziDecode(Block):
    """NRZI-S decode (reference src/nrzi.rs:37-42); carries the previous
    bit (0 at stream start, a Python int or a 0-d tensor)."""

    graph_capturable = False  # int() of the carried bit reads the card
    shard_halo = 1  # the carried previous bit (0 at stream start)

    def apply(self, x):
        return nrzi_decode(x)

    def state_from_tail(self, tail):
        return tail[:1].to(torch.uint8)

    def apply_ext(self, ext, n_local, in0, out0):
        # out[n] = 1 ^ x[n] ^ x[n-1] with the halo bit as x[-1], on the
        # card (the chunk form's int() of the carried bit would read it)
        ext = ext.to(torch.uint8)
        return 1 ^ ext[1:] ^ ext[:-1]

    def init_state(self):
        return 0

    def apply_chunk(self, state, x):
        x = x.to(torch.uint8)
        y = nrzi_decode(x, last=int(state))
        # a data-dependent upstream (clock recovery) can emit an empty
        # chunk; keep the carried bit then
        return (state if x.shape[0] == 0 else x[-1:].clone()), y


class NrziEncode(Block):
    """NRZI-S encode (reference src/nrzi.rs:64-69); carries the current
    line state (0 at stream start, a Python int or a 1-element tensor)."""

    graph_capturable = False  # int() of the carried bit reads the card

    def apply(self, x):
        return nrzi_encode(x)

    def init_state(self):
        return 0

    def apply_chunk(self, state, x):
        y = nrzi_encode(x, out0=int(state))
        return (state if y.shape[0] == 0 else y[-1:].clone()), y


class Descrambler(Block):
    """Feed-forward LFSR descramble (reference src/descrambler.rs); the
    streaming state is the last length+1 input bits (uint8)."""

    graph_capturable = False  # uploads its block matrices from numpy per call

    def __init__(self, mask: int = 0x21, seed: int = 0, length: int = 16):
        # the seed affects only the first length+1 outputs; the reference
        # notes it is irrelevant in practice (src/descrambler.rs:3-5): 0
        self.mask, self.length = mask, length

    @property
    def shard_halo(self):
        return self.length + 1  # feed-forward: state == input tail

    @classmethod
    def g3ruh(cls):
        return cls(0x21, 0, 16)

    def apply(self, x):
        return descramble(x, self.mask, self.length)

    def init_state(self):
        return torch.zeros(self.length + 1, dtype=torch.uint8)

    def apply_chunk(self, state, x):
        x = x.to(torch.uint8)
        state = state.to(x.device, torch.uint8)
        y = descramble(x, self.mask, self.length, history=state)
        ext = torch.cat([state, x])
        return ext[-(self.length + 1):].clone(), y


class Scrambler(Block):
    """LFSR scramble (reference src/descrambler.rs:39-45); the streaming
    state is the length+1 register bits (uint8)."""

    graph_capturable = False  # runs the register on the host

    def __init__(self, mask: int = 0x21, seed: int = 0, length: int = 16):
        self.mask, self.seed, self.length = mask, seed, length

    @classmethod
    def g3ruh(cls):
        return cls(0x21, 0, 16)

    def apply(self, x):
        y, _ = scramble(x, self.mask, self.length, self.seed)
        return y

    def init_state(self):
        return torch.tensor([(self.seed >> j) & 1 for j in range(self.length + 1)],
                            dtype=torch.uint8)

    def apply_chunk(self, state, x):
        y, s = scramble(x, self.mask, self.length, state=state)
        return s, y


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

    graph_capturable = False  # host: native, or events with its budget retry
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


class CorrelateAccessCode(Block):
    """1 on access-code match (reference src/correlate_access_code.rs), on
    the stream's device.

    Streaming state: the last ``len(code) - 1`` input bits (a uint8
    tensor), empty at stream start so that the first windows are not full
    there, as offline.  (The JAX package starts from ``len(code) - 1``
    zeros, which can match a code that begins with zeros before the window
    is full; a JAX tail resumed here is taken as it is.)"""

    graph_capturable = False  # uploads the code from numpy per call

    def __init__(self, code, allowed_diffs: int = 0):
        self.code = np.asarray(code, np.uint8)
        if self.code.size == 0:
            raise ValueError("access code must be nonempty")
        self.allowed_diffs = allowed_diffs

    @property
    def shard_halo(self):
        return len(self.code) - 1

    def shard_fn(self, di):
        """The tail plan of :class:`Block`, with the windows that reach
        before the true stream start (its first ``len(code) - 1``
        positions, past the ``di`` masked ones) set to 0, as offline: the
        zero halo at stream start could match a code that begins with
        zeros."""
        plan = super().shard_fn(di)
        if plan is None:
            return None
        start = di + len(self.code) - 1  # the first full window's mesh index

        def fn(ext, n_local, ctx):
            y = plan.fn(ext, n_local, ctx)
            if ctx.g_out < start:
                y = torch.cat([y.new_zeros(min(start - ctx.g_out, y.shape[0])),
                               y[start - ctx.g_out:]])
            return y

        return ShardFn(halo=plan.halo, d_out=plan.d_out, div=plan.div, fn=fn)

    def apply(self, x):
        return correlate_access_code(x, self.code, self.allowed_diffs)

    def init_state(self):
        return torch.zeros(0, dtype=torch.uint8)

    def apply_chunk(self, state, x):
        x = x.to(torch.uint8)
        state = torch.as_tensor(state).to(x.device, torch.uint8)
        ext = torch.cat([state, x])
        y = correlate_access_code(ext, self.code, self.allowed_diffs)
        keep = len(self.code) - 1
        return ext[max(ext.shape[0] - keep, 0):].clone(), y[state.shape[0]:]


class CorrelateAccessCodeTag(CorrelateAccessCode):
    """Passes the data through and tags each access-code match's position
    (its last bit) with ``tag`` (reference CorrelateAccessCodeTag).

    Streamed it carries the same tail as :class:`CorrelateAccessCode` and
    tags each match in the chunk where its last bit arrives, at its
    position in that chunk, the runner's convention (a sink adds the
    samples it took before), so a sink sees the offline run's tags.  The
    JAX package's block inherits the stream form of the correlator, which
    returns the match stream in place of the data and sets no matches
    (``AttributeError`` in ``process_tags``, ``rustradio_tpu/blocks/
    digital.py:157``)."""

    graph_capturable = False  # reads the matches back for its tags
    domain = "host"
    shard_halo = None  # its tags come from the host: no mesh plan

    def __init__(self, code, tag: str = "sync", allowed_diffs: int = 0):
        super().__init__(code, allowed_diffs)
        self.tag = tag
        self._match = np.zeros(0, np.int64)

    def apply(self, x):
        self._match = np.flatnonzero(super().apply(x).cpu().numpy())
        return x

    def apply_chunk(self, state, x):
        state, y = super().apply_chunk(state, x)
        self._match = np.flatnonzero(y.cpu().numpy())
        return state, x

    def process_tags(self, in_tags, out_lens):
        base = list(in_tags[0]) if in_tags else []
        base += [Tag(int(pos), self.tag, 0) for pos in self._match]
        return [sorted(base)]


class ZeroCrossing(Block):
    """Fixed-clock zero-crossing recovery (reference src/zero_crossing.rs)
    on the native recurrence (``native.zero_crossing_f32``); host-domain,
    its symbols a CPU tensor.

    Streaming state: ``{"sync": None}`` at stream start, then ``{"sync":
    {"last_sign": bool, "last_cross": f32, "counter": u32}}``, the JAX
    package's layout (a JAX state resumes here)."""

    graph_capturable = False  # host: native on the host
    domain = "host"

    def __init__(self, sps: float, max_deviation: float = 0.5):
        if not sps > 1.0:
            raise ValueError("sps must be > 1")
        self.sps = sps
        self.max_deviation = max_deviation

    def init_state(self):
        return {"sync": None}

    def _run(self, x, state):
        vals, new = native.zero_crossing_f32(x.detach().cpu().numpy(), self.sps,
                                             state=state)
        return torch.from_numpy(vals), new

    def apply(self, x):
        return self._run(x, None)[0]

    def apply_chunk(self, state, x):
        syms, new = self._run(x, state["sync"] if state else None)
        return {"sync": new}, syms
