"""Stream tags and PDUs (a copy of the part of ``rustradio_tpu/streams.py``
the blocks use; importing that module would pull in jax through the
``rustradio_tpu`` package ``__init__``).

A stream value is a whole chunk (or whole offline signal) as a tensor;
tags ride beside it as a host-side sorted list of (pos, key, value) —
sparse metadata never touches the device.  PDU streams are host lists of
:class:`Pdu` (the reference's "nocopy" queues, src/stream.rs:456-478).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, order=True)
class Tag:
    """Positioned metadata on a stream (reference src/stream.rs:50-93)."""

    pos: int
    key: str = dataclasses.field(compare=False)
    val: Any = dataclasses.field(compare=False)


@dataclasses.dataclass
class Pdu:
    """One packet data unit."""

    data: Any
    tags: list[Tag] = dataclasses.field(default_factory=list)
