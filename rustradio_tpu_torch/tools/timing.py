"""The timers, the card's identity and bounds, and the plain-version switch
shared by ``chip_smoke.py`` and the benchmark programs (``tools/bench*.py``).

Device times come from CUDA events: per call in a stream of calls
(``event_ms``, ``event_stats``), or the device alone from a replayed CUDA
graph (``graph_ms``).  Host times end in ``torch.cuda.synchronize()``
(``wall``, ``host_stats``); ``host_us`` is a wrapper's host cost a call.
Every timer except ``sync`` and ``wall`` needs a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import subprocess
import time
from unittest import mock

import torch


def sync() -> None:
    """Wait for the card, where there is one (a CPU rehearsal has none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def wall(fn, reps: int = 3):
    """Median host wall seconds of ``fn()`` between two synchronises, and
    its last result."""
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def time_pair(kernel_fn, plain_fn, plain_ctx, reps: int = 5, calls: int = 10,
              plain_calls: int | None = None):
    """Median over ``reps`` CUDA-event timings of each, after a warm-up,
    measured in turns; ``plain_fn`` runs inside ``plain_ctx()``.  One
    timing spans ``calls`` back-to-back calls (``plain_calls`` for the
    plain version, default the same) and is divided by that count, so the
    host's launch latency overlaps the device work as it does in a stream
    of calls."""
    plain_calls = calls if plain_calls is None else plain_calls
    event_ms(kernel_fn, contextlib.nullcontext, calls)
    event_ms(plain_fn, plain_ctx, plain_calls)
    k, p = [], []
    for _ in range(reps):
        k.append(event_ms(kernel_fn, contextlib.nullcontext, calls))
        p.append(event_ms(plain_fn, plain_ctx, plain_calls))
    return statistics.median(k), statistics.median(p)


def time_one(fn, reps: int = 5, calls: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of ``calls`` calls of
    ``fn`` (ms per call), after a warm-up."""
    event_ms(fn, contextlib.nullcontext, calls)
    return statistics.median(event_ms(fn, contextlib.nullcontext, calls)
                             for _ in range(reps))


def event_ms(fn, ctx, calls: int) -> float:
    """CUDA-event ms per call over ``calls`` back-to-back calls of ``fn``
    inside ``ctx()``."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with ctx():
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
    return s.elapsed_time(e) / calls


def graph_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Device ms per call without the host: ``fn(k)`` for k < ``calls``
    captured once into a CUDA graph (after a warm-up on a side stream),
    median over ``reps`` replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            fn(k)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return statistics.median(ts)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call: the wall time of ``calls`` calls with
    no synchronise between them (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def spread(samples) -> dict:
    """The median, the quartiles and the count of ``samples``."""
    s = sorted(samples)
    q1, _, q3 = (statistics.quantiles(s, n=4, method="inclusive") if len(s) > 1
                 else (s[0],) * 3)
    return {"median": statistics.median(s), "q1": q1, "q3": q3, "n": len(s)}


def event_stats(fn, reps: int = 5, calls: int = 10, warm: int = 2) -> dict:
    """``spread`` of ``reps`` CUDA-event timings of ``calls`` calls of
    ``fn`` (ms per call), after ``warm`` calls."""
    for _ in range(warm):
        fn()
    return spread(event_ms(fn, contextlib.nullcontext, calls)
                  for _ in range(reps))


def host_stats(fn, reps: int = 5, warm: int = 1) -> dict:
    """``spread`` of ``reps`` host walls of ``fn()`` in ms, each ended by a
    synchronise, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    return spread(wall(fn, reps=1)[0] * 1e3 for _ in range(reps))


@dataclasses.dataclass(frozen=True)
class Card:
    """The card a run measures: ``torch.cuda.get_device_name`` and
    ``nvidia-smi``'s power limit (W)."""

    name: str
    power_limit_w: float | None

    def fields(self) -> dict:
        return {"card": self.name, "power_limit_w": self.power_limit_w}


def _smi(query: str) -> list[float | None]:
    """The first card's ``nvidia-smi --query-gpu`` numbers (None where a
    field is not a number)."""
    line = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = []
    for field in line.split(","):
        try:
            out.append(float(field))
        except ValueError:
            out.append(None)
    return out


def card() -> Card:
    """The first card, as :class:`Card`."""
    return Card(torch.cuda.get_device_name(0), _smi("power.limit")[0])


def sm_clock_mhz() -> float | None:
    """The first card's SM clock now (read right after a timed run, it is
    the clock under that load, or close to it)."""
    return _smi("clocks.sm")[0]


def bound(work, name: str | None = None):
    """(ms, "bytes" or "operations"): the least time the card ``name``
    (the first card by default) could take for ``work`` (bytes, f32
    operations; ``kernels.*_work``), the larger of the bytes over its
    memory rate and the operations over its peak (``utils.stats``)."""
    from ..utils import stats

    name = torch.cuda.get_device_name(0) if name is None else name
    peaks = stats.card_peaks(name)
    if peaks is None:
        raise SystemExit(f"no peaks known for {name} (utils/stats.py)")
    return stats.bound_ms(*work, *peaks)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel call to its plain PyTorch version on the tensors'
    device (same inputs, same surrounding code); asserts no kernel
    launched."""
    from ..ops import kernels

    before = dict(kernels.LAUNCHES)
    with mock.patch.object(kernels, "fir_decimate",
                           kernels.fir_decimate_plain), \
         mock.patch.object(kernels, "fm_chain_span",
                           kernels.fm_chain_span_plain), \
         mock.patch.object(kernels, "quad_demod_fast",
                           kernels.quad_demod_fast_plain), \
         mock.patch.object(kernels, "symbol_sync_scan",
                           kernels.symbol_sync_scan_plain), \
         mock.patch.object(kernels, "symbol_sync_events_scan",
                           kernels.symbol_sync_events_scan_plain), \
         mock.patch.object(kernels, "cma_scan", kernels.cma_scan_plain), \
         mock.patch.object(kernels, "iir_scan", kernels.iir_scan_plain):
        yield
    if kernels.LAUNCHES != before:
        raise SystemExit("a plain run launched a kernel")
