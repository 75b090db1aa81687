"""Throughput and roofline accounting (port of
``rustradio_tpu/utils/stats.py``).

The reference prints a per-block wall and CPU time table after every run
(src/graph.rs:175-257); ``Graph.generate_stats()`` covers that.  This
module holds the cards' peaks that the roofline columns and the kernels'
bounds divide by, rate metering for streaming feeds, and the device's busy
share read from a ``torch.profiler`` trace.

The peaks are NVIDIA's data-sheet figures, matched on
``torch.cuda.get_device_name()``: device memory in GB/s and f32
operations a second outside the tensor cores.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

#: (name substring, device memory GB/s, f32 peak operations/s); the first
#: match wins, so the PCIe card comes before the SXM one.
CARDS = (
    ("H100 PCIe", 2000.0, 51.2e12),
    ("H100", 3350.0, 67e12),
)


def card_peaks(name: str) -> tuple[float, float] | None:
    """(GB/s, f32 operations/s) of the card named ``name``; None for a
    card the table does not hold."""
    for key, gbps, flops in CARDS:
        if key.lower() in name.lower():
            return gbps, flops
    return None


def device_hbm_gbps(device=None) -> float | None:
    """The device memory rate of ``device`` (the current card by
    default), GB/s; None for the CPU or a card the table does not hold."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    peaks = card_peaks(torch.cuda.get_device_name(device))
    return None if peaks is None else peaks[0]


def bound_ms(nbytes: float, flops: float, gbps: float, peak: float):
    """(ms, "bytes" or "operations"): the least time a card of these peaks
    could take for the work, the larger of the bytes over its memory rate
    and the f32 operations over its peak."""
    tb = nbytes / (gbps * 1e9) * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


@dataclasses.dataclass
class RateMeter:
    """Track samples/s over a streaming run."""

    samples: int = 0
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    def add(self, n: int):
        self.samples += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def msps(self) -> float:
        return self.samples / max(self.elapsed, 1e-12) / 1e6

    def report(self) -> str:
        return f"{self.samples} samples in {self.elapsed:.3f}s = {self.msps:.1f} Msps"


def roofline_report(bytes_moved: int, seconds: float, device=None) -> str:
    """Achieved bandwidth against the card's device memory rate."""
    gbps = bytes_moved / max(seconds, 1e-12) / 1e9
    roof = device_hbm_gbps(device)
    if roof is None:
        return f"{gbps:.1f} GB/s (no device memory rate known for this device)"
    return f"{gbps:.1f} GB/s ({100 * gbps / roof:.0f}% of ~{roof:.0f} GB/s)"


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_share(trace_path: str):
    """Busy share of the device in a ``torch.profiler`` Chrome trace:
    ``(busy_s, span_s, device_events)``, the union of the device's kernel,
    copy and fill intervals, the span from the trace's first event to its
    last, and how many device events it holds (0: the profiler saw no
    device activity, and the share is unknown)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        spans.append((t0, t1))
        if str(e.get("cat", "")).lower() in _DEVICE_CATS:
            dev.append((t0, t1))
    if not spans:
        return 0.0, 0.0, 0
    span = max(t for _, t in spans) - min(t for t, _ in spans)
    busy, end = 0.0, -float("inf")
    for t0, t1 in sorted(dev):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy * 1e-6, span * 1e-6, len(dev)
