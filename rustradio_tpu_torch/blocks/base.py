"""Block protocol (port of ``rustradio_tpu/blocks/base.py``).

The reference's Block trait is ``work(&mut self) -> BlockRet`` driven by a
dynamic scheduler (src/block.rs:112-126).  Here a block is a small class
holding its parameters: a function over whole streams (offline mode) plus
a chunk form with carried state (streaming mode).  Stream values are
tensors; a block runs on its inputs' device.  A block that can run with
the time axis sharded over a mesh declares its plan (``shard_halo``,
``shard_fn``; ``parallel/graph_mesh.py``).

The batch protocol of ``Graph.run_stream(scan_chunks=)``: a source may
define ``emit_batch(offset, chunk_size, nb, device)``, which gives a whole
batch as one stacked ``(nb, chunk)`` tensor, and an ``n_out == 0`` block
may define ``accept_batch(*stacked)`` to take one (it then owns any
per-chunk handling; a block with ``accept_tags`` gets the chunks one at a
time).
"""

from __future__ import annotations

import dataclasses

from ..streams import Tag


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Position context the mesh runner hands a block's shard fn.

    ``g_in``/``g_out`` — global input/output index of the local window's
    first sample; ``k`` — the shard's coordinate along the sharded mesh
    axis, the same on every line of a mesh of several axes, so a block
    sees on a line of a (chan, time) mesh the positions of a 1-D mesh of
    that axis's size (Python ints: the shards are driven from one host loop, so the
    positions are exact int64 values, not traced int32 scalars);
    ``aux`` — this chunk's host-computed scalar from ``ShardFn.prep``,
    None when the block declares no prep.
    """

    g_in: int
    g_out: int
    k: int
    aux: object = None


@dataclasses.dataclass(frozen=True)
class ShardFn:
    """One block's time-sharding contract (see Block.shard_fn).

    ``fn(ext, n_local, ctx)`` computes the block's outputs for a local
    window of the stream given ``ext = [halo history | local]``, where
    the history is the previous ``halo`` input samples (zeros at global
    stream start — every shardable block here has zero-history streaming
    semantics) and ``ctx`` is a :class:`ShardCtx`.

    ``prep(in0)`` — optional host hook, called once per chunk with the
    block's global mesh input offset (Python int): returns a float the
    runner passes in as ``ctx.aux`` (e.g. a rotator phase reduced mod 2π
    in float64 once a chunk).
    """

    halo: int  # input history samples exchanged between shards
    d_out: int  # garbage outputs at global stream start (masked to 0)
    div: int  # the local input length must be divisible by this
    fn: object
    prep: object = None


class Block:
    """Base graph node.

    Class attributes:

    * ``n_in`` / ``n_out`` — port counts.
    * ``domain`` — "device" (may be fused by the graph's lowering) or "host".
    * ``interp`` / ``deci`` — nominal rate ratio, used for tag rescaling.
    * ``graph_capturable`` — the JAX package's ``jit_chunk``
      (``rustradio_tpu/blocks/base.py:79-82``) read for CUDA graphs: True
      when the chunk form can be recorded once into a CUDA graph and
      replayed, i.e. it only enqueues device work whose launches depend on
      nothing but the shapes of its inputs and state: it reads nothing
      back from the card (``.item()``, ``.cpu()``, ``int()`` of a tensor),
      runs no numpy on the chunk's data and copies nothing from pageable
      host memory, and a number in its state is a counter that no output
      reads.  Every block class sets it (False here); a block whose
      answer depends on its parameters sets it per instance.
    """

    n_in = 1
    n_out = 1
    domain = "device"
    interp = 1
    deci = 1
    graph_capturable = False

    def name(self) -> str:
        return type(self).__name__

    # ---- offline ----
    def apply(self, *xs):
        """Whole-stream function. Returns one tensor or a tuple."""
        raise NotImplementedError

    # ---- streaming ----
    def init_state(self):
        """Carried state; None for stateless blocks."""
        return None

    def apply_chunk(self, state, *xs):
        """Chunk form: (state', outputs). Default: stateless == offline.

        Must produce, over concatenated chunks, exactly the same stream as
        ``apply`` over the concatenated input.
        """
        return state, self.apply(*xs)

    # ---- time sharding (mesh execution) ----
    # The reference gets multi-core execution by swapping Graph for
    # MTGraph (src/mtgraph.rs:73-149).  Here a chain of blocks runs with
    # the sample axis sharded over a mesh (``parallel.graph_mesh``), and
    # each block's filter history crosses shard boundaries as a halo
    # instead of carried state.  A block opts in by declaring
    # ``shard_halo`` — the same tail-of-input quantity its apply_chunk
    # already carries as streaming state.
    shard_halo: int | None = None  # None = not time-shardable
    shard_extra_drop = 0  # leading outputs streaming mode never emits

    def state_from_tail(self, tail):
        """Build this block's streaming state from the last ``shard_halo``
        input samples (used by the default apply_ext).  Default: the
        state IS the tail."""
        return tail

    def shard_state(self, tail, consumed: int):
        """Streaming state equivalent to having consumed ``consumed``
        samples whose last ``shard_halo`` are ``tail``.  For the
        tail-state family this is position-independent.  Halo-free
        blocks are called with ``tail=None``; position-dependent ones
        (e.g. a rate changer) override this to rebuild their offsets from
        ``consumed``."""
        if tail is None and not self.shard_halo:
            return self.init_state()
        return self.state_from_tail(tail)

    def apply_ext(self, ext, n_local, in0, out0):
        """Outputs for the local window given ``ext = [halo | local]``.

        Default: reuse the streaming chunk form with the halo as state —
        exact for every block whose state is its input tail."""
        if not self.shard_halo:
            return self.apply(ext)
        _, y = self.apply_chunk(
            self.state_from_tail(ext[: self.shard_halo]), ext[self.shard_halo :]
        )
        return y

    def shard_fn(self, di: int) -> ShardFn | None:
        """Time-sharding plan given ``di`` = garbage samples prepended to
        this block's input at global stream start (cumulative drops of
        upstream blocks in the same chain; the runner masks them to 0 so
        zero-history semantics compose).  None = not shardable.
        """
        if (
            self.shard_halo is None
            or self.n_in < 1
            or self.n_out < 1
            or self.deci != 1
            or self.interp != 1
        ):
            return None
        if self.n_in >= 2:
            # multi-input blocks shard only as pure elementwise combiners
            # (no halo, same rate): the planner verifies all inputs share
            # one rate and stream-start drop, and passes the exts tuple
            if self.shard_halo != 0:
                return None
            return ShardFn(
                halo=0,
                d_out=di + self.shard_extra_drop,
                div=1,
                fn=lambda exts, n, ctx: self.apply(*exts),
            )
        return ShardFn(
            halo=self.shard_halo,
            d_out=di + self.shard_extra_drop,
            div=1,
            fn=lambda ext, n, ctx: self.apply_ext(ext, n, ctx.g_in, ctx.g_out),
        )

    def shard_total_out(self, n: int) -> int:
        """Total outputs the streaming path emits for an n-sample stream
        (used to trim padding artifacts at end-of-stream)."""
        return max(0, n * self.interp // self.deci - self.shard_extra_drop)

    # ---- tags ----
    def process_tags(self, in_tags: list[list[Tag]], out_lens) -> list[list[Tag]]:
        """Map input-port tag lists to output-port tag lists.

        Default: pass port-0 tags to every output, positions rescaled by
        interp/deci and clipped to the output length.
        """
        src = in_tags[0] if in_tags else []
        out = []
        for n in out_lens:
            out.append(
                [
                    Tag(t.pos * self.interp // self.deci, t.key, t.val)
                    for t in src
                    if t.pos * self.interp // self.deci < n
                ]
            )
        return out


class SourceBlock(Block):
    """A block with no inputs; produces n samples from a stream offset on
    the device the caller names."""

    n_in = 0

    def total_len(self):
        """Total stream length for offline mode, or None if unbounded."""
        return None

    def emit(self, offset: int, n: int, device):
        """Produce samples [offset, offset+n) of the stream on ``device``."""
        raise NotImplementedError

    def emit_tags(self, offset: int, n: int) -> list[Tag]:
        return []

    def apply(self, device):
        total = self.total_len()
        if total is None:
            raise ValueError(
                f"{self.name()} is unbounded; offline mode needs a finite source"
            )
        return self.emit(0, total, device)
