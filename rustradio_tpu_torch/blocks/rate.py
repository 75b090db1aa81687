"""Rate-changing and position blocks (port of ``RationalResampler``,
``Delay``, ``Skip`` and ``Head`` from ``rustradio_tpu/blocks/rate.py``).
Each runs on its input's device."""

from __future__ import annotations

import math

import torch

from ..ops.delay import head, skip
from ..ops.resampler import rational_resampler
from ..streams import Tag
from .base import Block, ShardFn


class RationalResampler(Block):
    """Gather resampler (reference src/rational_resampler.rs:154-206).

    Streaming: output k comes from input floor(k*deci/interp) of the whole
    stream, so a chunk computes its window of global indices from two
    offsets, the inputs and the outputs so far.  They are Python ints in
    the carried state, as in the JAX package, so a checkpoint of either
    package carries them.
    """

    graph_capturable = False  # its host offsets pick the gathered indices

    def __init__(self, interp: int, deci: int):
        if interp <= 0 or deci <= 0:
            raise ValueError("RationalResampler interp/deci must be > 0")
        g = math.gcd(interp, deci)
        self.interp = interp // g
        self.deci = deci // g

    def apply(self, x):
        return rational_resampler(x, self.interp, self.deci)

    def shard_fn(self, di):
        """Mesh plan: the counter algorithm's output position is a pure
        function of the global input offset (reference
        src/rational_resampler.rs:183-198 — the counter evolves
        linearly), so a shard's outputs are one gather.

        With the local input length divisible by ``deci`` (div), the
        output count is exactly ``L*interp/deci`` regardless of offset.
        For TRUE-stream input offset a, output k maps to input
        floor(k*deci/interp); the shard's first output is
        k0 = ceil(a*interp/deci).  The ``di`` garbage samples upstream
        blocks prepend at stream start shift the mesh coordinates off
        the true stream, so the gather anchors at a = g_in - di, folded
        into a nonnegative offset mod interp*deci: it sets the grid's
        PHASE, which is wrong whenever di*interp % deci != 0 without it.
        The leading floor(di*interp/deci) outputs read the garbage
        prefix and are masked by the runner.  (The positions are int64
        host values here, so the mod only keeps the JAX form's anchor.)"""
        interp, deci = self.interp, self.deci
        period = interp * deci
        off = (-di) % period  # g_in + off == g_in - di (mod period), >= 0

        def fn(ext, n_local, ctx):
            rem = (ctx.g_in + off) % period
            r0 = (rem * interp + (deci - 1)) // deci  # ceil(rem*I/D)
            j = torch.arange(n_local * interp // deci, dtype=torch.int64,
                             device=ext.device)
            idx = (r0 + j) * deci // interp - rem
            return ext[idx]

        return ShardFn(halo=0, d_out=di * interp // deci, div=deci, fn=fn)

    def shard_total_out(self, n):
        return -(-n * self.interp // self.deci)

    def shard_state(self, tail, consumed):
        # position-dependent host state: the offsets from the global
        # consumed count
        return {
            "in_off": int(consumed),
            "out_off": -(-int(consumed) * self.interp // self.deci),
        }

    def init_state(self):
        return {"in_off": 0, "out_off": 0}

    def apply_chunk(self, state, x):
        n = x.shape[0]
        in_off, out_off = int(state["in_off"]), int(state["out_off"])
        # outputs k with floor(k*deci/interp) in [in_off, in_off+n)
        out_end = -(-(in_off + n) * self.interp // self.deci)  # ceil
        k = torch.arange(out_off, out_end, dtype=torch.int64, device=x.device)
        idx = (k * self.deci) // self.interp - in_off
        return {"in_off": in_off + n, "out_off": out_end}, x[idx]


class Delay(Block):
    """Zero-filled delay (reference src/delay.rs): ``delay`` zeros, then
    the input stream.

    Two modes:

    * static (default) — a device block: each chunk's output keeps the
      chunk's length (the last ``delay`` samples are carried), and the
      carried samples drain at the end of the stream through the graph's
      flush pass, so the whole stream is the reference's N + delay.
    * ``dynamic=True`` — runtime ``set_delay`` (e.g. from a control
      thread): a larger delay inserts zeros before the next chunk, a
      smaller one skips input until caught up (the reference's
      ``current_delay``/``skip`` arithmetic, src/delay.rs:42-53, 58-105).
      The output length varies per chunk, so this mode is a host block.
    """

    graph_capturable = False  # host counters decide what each chunk emits

    def __init__(self, n: int, dynamic: bool = False):
        if n < 0:
            raise ValueError("delay must be >= 0")
        self.delay = n
        self.dynamic = dynamic
        self._pending: list[int] = []
        self._zeros_this = 0
        self._skip_this = 0
        self._carried_tags: list[Tag] = []
        if dynamic:
            self.domain = "host"

    def set_delay(self, n: int) -> None:
        """Queue a delay change; takes effect at the next chunk."""
        if not self.dynamic:
            raise ValueError("runtime set_delay needs Delay(n, dynamic=True)")
        if n < 0:
            raise ValueError("delay must be >= 0")
        self._pending.append(n)

    def init_state(self):
        self._carried_tags = []
        if not self.dynamic:
            return None  # the carried tail, typed by the first chunk
        return {"current": self.delay, "skip": 0}

    def _drain_pending(self, current: int, skip: int):
        for d in self._pending:
            if d > self.delay:
                current += d - self.delay
            else:
                reduce = self.delay - d
                c = min(current, reduce)
                current -= c
                skip += reduce - c
            self.delay = d
        self._pending.clear()
        return current, skip

    def apply_chunk(self, state, x):
        if not self.dynamic:
            if state is None:
                state = x.new_zeros((self.delay, *x.shape[1:]))
            ext = torch.cat([state.to(x.device, x.dtype), x])
            return ext[x.shape[0]:], ext[: x.shape[0]]
        current, skip = self._drain_pending(int(state["current"]),
                                            int(state["skip"]))
        k = min(skip, x.shape[0])
        self._zeros_this, self._skip_this = current, k
        out = torch.cat([x.new_zeros((current, *x.shape[1:])), x[k:]])
        return {"current": 0, "skip": skip - k}, out

    def flush_with_state(self, state):
        # static mode: the carried tail (the stream's last `delay` samples)
        # drains at the end of the stream, making the total N + delay
        if self.dynamic or state is None or self.delay == 0:
            return None
        return state

    # the carried tags ride on the host; checkpoints keep them, so a tag in
    # a chunk's last `delay` samples survives a checkpoint/resume boundary
    def host_state(self):
        return list(self._carried_tags)

    def restore_host_state(self, hs):
        self._carried_tags = [Tag(int(t.pos), t.key, t.val) for t in hs]

    def apply(self, x):
        if not self.dynamic:
            return torch.cat([x.new_zeros((self.delay, *x.shape[1:])), x])
        _, out = self.apply_chunk(self.init_state(), x)
        return out

    def process_tags(self, in_tags, out_lens):
        # input tags ride their samples, shifted by the zeros emitted ahead
        # of them this chunk (the zero-fill carries no tags,
        # src/delay.rs:96-101)
        src = in_tags[0] if in_tags else []
        if not self.dynamic:
            # a tag whose delayed position lands past this chunk rides the
            # carried tail and comes out in the next chunk (or the drain)
            n = out_lens[0] if out_lens else 0
            allt = self._carried_tags + [
                Tag(t.pos + self.delay, t.key, t.val) for t in src
            ]
            keep = sorted(t for t in allt if t.pos < n)
            self._carried_tags = [
                Tag(t.pos - n, t.key, t.val) for t in allt if t.pos >= n
            ]
            return [list(keep) for _ in out_lens]
        shift, k = self._zeros_this, self._skip_this
        return [
            [
                Tag(t.pos - k + shift, t.key, t.val)
                for t in src
                if t.pos >= k and t.pos - k + shift < n
            ]
            for n in out_lens
        ]


class Skip(Block):
    """Drop the first n samples (reference src/skip.rs)."""

    graph_capturable = False  # a host counter decides what each chunk drops

    def __init__(self, n: int):
        self.n = n

    def apply(self, x):
        return skip(x, self.n)

    def init_state(self):
        return {"left": self.n}

    def apply_chunk(self, state, x):
        take = min(int(state["left"]), x.shape[0])
        return {"left": int(state["left"]) - take}, x[take:]


class Head(Block):
    """Pass the first n samples, then nothing (reference src/head.rs)."""

    graph_capturable = False  # a host counter decides what each chunk keeps

    def __init__(self, n: int):
        self.n = n

    def apply(self, x):
        return head(x, self.n)

    def init_state(self):
        return {"left": self.n}

    def apply_chunk(self, state, x):
        take = min(int(state["left"]), x.shape[0])
        return {"left": int(state["left"]) - take}, x[:take]
