"""Packet blocks (port of ``HdlcDeframer`` from
``rustradio_tpu/blocks/packets.py``).  PDU streams flow between host
blocks as lists of :class:`~rustradio_tpu_torch.streams.Pdu`."""

from __future__ import annotations

from ..ops.hdlc import HdlcStateMachine
from ..streams import Pdu, Tag
from .base import Block


class HdlcDeframer(Block):
    """Bit stream -> packet PDUs (reference src/hdlc_deframer.rs), each
    tagged with its frame-end bit position (``packet_pos``).  The resumable
    state machine carries frames across chunk boundaries; its snapshot is
    the streaming (and checkpointed) state."""

    domain = "host"

    def __init__(self, min_size: int = 10, max_size: int = 1500,
                 fix_bits: bool = False, keep_checksum: bool = False):
        self.min_size, self.max_size = min_size, max_size
        self.fix_bits, self.keep_checksum = fix_bits, keep_checksum
        self._sm = self._machine()

    def _machine(self) -> HdlcStateMachine:
        return HdlcStateMachine(self.min_size, self.max_size,
                                self.keep_checksum, self.fix_bits)

    @property
    def stats(self):
        return self._sm.stats

    @staticmethod
    def _emit(pkts):
        return [Pdu(d, [Tag(0, "packet_pos", int(p))]) for d, p in pkts]

    def apply(self, x):
        return self._emit(self._sm.feed(x))

    def init_state(self):
        self._sm = self._machine()
        return self._sm.snapshot()

    def apply_chunk(self, state, x):
        self._sm.restore(state)
        pdus = self._emit(self._sm.feed(x))
        return self._sm.snapshot(), pdus
