"""Burst tagging and stream -> PDU extraction (port of
``rustradio_tpu/ops/burst.py``).

* ``burst_tagger`` (reference src/burst_tagger.rs): compares a trigger
  stream against a threshold and emits edge markers — a compare and a
  shift on the trigger's device.
* ``stream_to_pdu`` (reference src/stream_to_pdu.rs:167-260): cuts the data
  stream into bursts [start_edge, end_edge) plus ``tail`` extra samples,
  dropping bursts longer than ``max_size``.  The edges' positions decide
  the cuts: they are found on the edge streams' device and only they are
  read on the host (``burst_cuts``), not the streams; the bursts are slices
  of the data, on its device.
"""

from __future__ import annotations

import numpy as np
import torch


def burst_tagger(trigger, threshold: float, last: bool = False):
    """Returns (start_edges, end_edges) boolean streams.

    start[i] is True where trigger crosses above threshold at i, end[i]
    where it crosses back at or below.  ``last`` is the carried previous
    comparison for streaming (reference src/burst_tagger.rs:69-86).  The
    threshold is taken in the trigger's precision, as the JAX package
    takes it.
    """
    trigger = torch.as_tensor(trigger)
    thr = torch.tensor(threshold, dtype=trigger.dtype).item()
    cur = trigger > thr
    prev = torch.cat([cur.new_full((1,), bool(last)), cur[:-1]])[: cur.shape[0]]
    return cur & ~prev, ~cur & prev


def _edges(start, end) -> np.ndarray:
    """(3, k) int64 on the host: each edge's position and its start and end
    flags.  Tensors are searched on their device, so that only the edges
    are copied."""
    if torch.is_tensor(start) and torch.is_tensor(end):
        start, end = start.to(torch.bool), end.to(torch.bool)
        pos = torch.nonzero(start | end).flatten()
        return torch.stack([pos, start[pos].long(), end[pos].long()]).cpu().numpy()
    start, end = np.asarray(start, bool), np.asarray(end, bool)
    pos = np.flatnonzero(start | end)
    return np.stack([pos, start[pos], end[pos]]).astype(np.int64)


def burst_cuts(start, end, n: int, max_size: int, tail: int = 0):
    """The cuts of ``stream_to_pdu`` over a stream of ``n`` samples:
    ([(first, stop)] of the bursts kept, the count dropped as longer than
    ``max_size``)."""
    cuts, too_long = [], 0
    in_burst = False
    burst_start = 0
    for i, is_start, is_end in _edges(start, end).T.tolist():
        if not in_burst and is_start:
            in_burst = True
            burst_start = i
        elif in_burst and is_end:
            stop = min(i + tail, n)
            if stop - burst_start <= max_size:
                cuts.append((burst_start, stop))
            else:
                too_long += 1
            in_burst = False
    return cuts, too_long


def stream_to_pdu(data, start, end, max_size: int, tail: int = 0) -> list:
    """Extract bursts from ``data`` given start/end edge streams.

    Semantics match the reference state machine (src/stream_to_pdu.rs):
    samples from the start-tagged sample up to (excluding) the end-tagged
    sample, plus ``tail`` samples starting at the end-tagged one; bursts
    longer than ``max_size`` are dropped; an unterminated burst at stream
    end is dropped (the reference would keep waiting).  The bursts are
    slices of ``data`` (tensors on its device, or numpy arrays).
    """
    cuts, _ = burst_cuts(start, end, len(data), max_size, tail)
    return [data[a:b] for a, b in cuts]


def pdu_to_stream(pdus: list):
    """Concatenate PDUs back into a stream (reference src/pdu_to_stream.rs),
    on the PDUs' device."""
    if not pdus:
        return torch.zeros(0)
    return torch.cat([torch.as_tensor(p) for p in pdus])


def pdu_average(pdus: list):
    """Elementwise mean of equal-length PDUs (reference src/pdu_average.rs)."""
    x = torch.stack([torch.as_tensor(p) for p in pdus])
    return x.mean(0) if x.is_floating_point() or x.is_complex() else x.double().mean(0)
