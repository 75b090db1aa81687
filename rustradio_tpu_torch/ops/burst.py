"""Burst tagging and stream -> PDU extraction (port of
``rustradio_tpu/ops/burst.py``).

* ``burst_tagger`` (reference src/burst_tagger.rs): compares a trigger
  stream against a threshold and emits edge markers — a compare and a
  shift on the trigger's device.
* ``stream_to_pdu`` (reference src/stream_to_pdu.rs:167-260): cuts the data
  stream into bursts [start_edge, end_edge) plus ``tail`` extra samples,
  dropping bursts longer than ``max_size``.  The edges are read on the host
  (their positions decide the cuts); the bursts are slices of the data, on
  its device.
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


def _host_bool(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, bool)


def stream_to_pdu(data, start, end, max_size: int, tail: int = 0) -> list:
    """Extract bursts from ``data`` given start/end edge streams.

    Semantics match the reference state machine (src/stream_to_pdu.rs):
    samples from the start-tagged sample up to (excluding) the end-tagged
    sample, plus ``tail`` samples starting at the end-tagged one; bursts
    longer than ``max_size`` are dropped; an unterminated burst at stream
    end is dropped (the reference would keep waiting).  The bursts are
    slices of ``data`` (tensors on its device, or numpy arrays).
    """
    start = _host_bool(start)
    end = _host_bool(end)
    pdus = []
    in_burst = False
    burst_start = 0
    n = len(data)
    for i in np.flatnonzero(start | end).tolist():
        if not in_burst and start[i]:
            in_burst = True
            burst_start = i
        elif in_burst and end[i]:
            seg = data[burst_start : min(i + tail, n)]
            if len(seg) <= max_size:
                pdus.append(seg)
            in_burst = False
    return pdus


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
