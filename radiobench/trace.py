"""The traced window: a ``torch.profiler`` session around it, read in
memory, and the arithmetic the per-layer metrics share.

The window's ends are two zero-length markers, ``rb::open`` and
``rb::close``, so every interval is measured on the profiler's own clock.
Device activity is every CUDA kernel, copy and fill (not the annotations
that the profiler projects on the device's timeline); host spans are the
CPU events of the thread that opened the window.  The busy-share
arithmetic (the union of the device's intervals) is a copy of the
program's ``utils.stats.device_busy_share``, kept here so that no change
to the program moves it.
"""

from __future__ import annotations

import dataclasses

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_ns(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of ``(start, end)`` intervals, clipped to
    [lo, hi] where given."""
    total, end = 0.0, -float("inf")
    for t0, t1 in sorted(intervals):
        if lo is not None:
            t0 = max(t0, lo)
        if hi is not None:
            t1 = min(t1, hi)
        if t1 <= t0 or t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def gaps_ns(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for t0, t1 in sorted(intervals):
        if t1 <= cur:
            continue
        if t0 > cur:
            out.append((cur, min(t0, hi)))
        cur = max(cur, t1)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Span:
    name: str
    start: float  # ns, the profiler's clock
    end: float


@dataclasses.dataclass
class Trace:
    """The window's events: ``device`` (kernels, copies, fills), ``host``
    (the window thread's CPU events and annotations), and the window's
    ends ``lo`` and ``hi``."""

    device: list[Span]
    host: list[Span]
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy_s(self) -> float:
        return union_ns([(s.start, s.end) for s in self.device],
                        self.lo, self.hi) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most
        time in the window."""
        by: dict[str, float] = {}
        for s in self.device:
            d = min(s.end, self.hi) - max(s.start, self.lo)
            if d > 0:
                by[s.name] = by.get(s.name, 0.0) + d * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]]: the device's idle time in
        the window by the innermost host span open at each gap's middle
        (an ``rr::`` block span where one is open), the largest first."""
        host = sorted((s for s in self.host
                       if s.name not in ("rb::open", "rb::close")),
                      key=lambda s: (s.start, -s.end))
        by: dict[str, float] = {}
        stack: list[Span] = []  # the spans open at the sweep's point
        j = 0
        for a, b in gaps_ns([(s.start, s.end) for s in self.device],
                            self.lo, self.hi):
            mid = (a + b) / 2
            while j < len(host) and host[j].start <= mid:
                while stack and stack[-1].end < host[j].start:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            name = "no host span"
            if stack:
                inner = stack[-1]
                block = next((s for s in reversed(stack)
                              if s.name.startswith("rr::") and s.end >= mid), None)
                name = inner.name if block is None or block is inner else \
                    f"{block.name} > {inner.name}"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _device_work(e, name: str) -> bool:
    """Whether a device event is work (a kernel, copy or fill), not an
    annotation projected on the device's timeline or a wait."""
    annotation = getattr(e, "is_user_annotation", None)
    if (annotation is not None and annotation()) or name.startswith(("rr::", "rb::")):
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        if kind not in DEVICE_KINDS and "kernel" not in kind:
            return False
    return not name.endswith("Sync")


class Tracer:
    """A ``torch.profiler`` session over the window (CPU, and CUDA
    activity where the run is on a card)."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    @staticmethod
    def mark(name: str) -> None:
        import torch

        with torch.profiler.record_function(f"rb::{name}"):
            pass

    def read(self) -> Trace:
        """The window's events, from the profiler's results in memory."""
        events = self._prof.profiler.kineto_results.events()
        marks: dict[str, tuple[float, int]] = {}
        device, cpu = [], []
        for e in events:
            name = e.name()
            t0 = float(e.start_ns())
            t1 = t0 + float(e.duration_ns())
            if "cuda" in str(e.device_type()).lower():
                if _device_work(e, name):
                    device.append(Span(name, t0, t1))
                continue
            if name in ("rb::open", "rb::close"):
                marks[name] = (t0, e.start_thread_id())
            cpu.append((e.start_thread_id(), Span(name, t0, t1)))
        if "rb::open" not in marks or "rb::close" not in marks:
            raise RuntimeError("the trace lacks the window's markers")
        lo, tid = marks["rb::open"]
        hi = marks["rb::close"][0]
        host = [s for t, s in cpu if t == tid]
        return Trace(device=device, host=host, lo=lo, hi=hi)
