"""Block protocol (port of ``rustradio_tpu/blocks/base.py``).

The reference's Block trait is ``work(&mut self) -> BlockRet`` driven by a
dynamic scheduler (src/block.rs:112-126).  Here a block is a small class
holding its parameters: a function over whole streams (offline mode) plus
a chunk form with carried state (streaming mode).  Stream values are
tensors; a block runs on its inputs' device.  Shard hooks come with the
multi-device slice.
"""

from __future__ import annotations

from ..streams import Tag


class Block:
    """Base graph node.

    Class attributes:

    * ``n_in`` / ``n_out`` — port counts.
    * ``domain`` — "device" (may be fused by the graph's lowering) or "host".
    * ``interp`` / ``deci`` — nominal rate ratio, used for tag rescaling.
    """

    n_in = 1
    n_out = 1
    domain = "device"
    interp = 1
    deci = 1

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
