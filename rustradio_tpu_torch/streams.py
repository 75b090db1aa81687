"""Stream tags and PDUs (a copy of ``rustradio_tpu/streams.py``; importing
that module would pull in jax through the ``rustradio_tpu`` package
``__init__``).

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


def scale_tags(tags: list[Tag], interp: int = 1, deci: int = 1) -> list[Tag]:
    """Rescale tag positions across a rate change (reference FirFilter
    rescales tag.pos/deci, src/fir.rs:533-541)."""
    if interp == 1 and deci == 1:
        return list(tags)
    return [Tag(t.pos * interp // deci, t.key, t.val) for t in tags]


def shift_tags(tags: list[Tag], offset: int) -> list[Tag]:
    return [Tag(t.pos + offset, t.key, t.val) for t in tags]


def filter_tags(tags: list[Tag], lo: int, hi: int) -> list[Tag]:
    return [t for t in tags if lo <= t.pos < hi]


@dataclasses.dataclass
class StreamValue:
    """One evaluated stream: data tensor + tags."""

    data: Any  # a 1-D tensor
    tags: list[Tag] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Pdu:
    """One packet data unit."""

    data: Any
    tags: list[Tag] = dataclasses.field(default_factory=list)
