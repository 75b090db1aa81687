"""Kernel G alone, on one NVIDIA GPU: its device time at the held window
(2^14 samples) and the main path's stream (2^24) at orders 2, 8 and 32,
the share of its bytes bound, the wrapper's host cost, and each of its
passes by name under ``torch.profiler``.

    python -m rustradio_tpu_torch.tools.time_iir [label]

Each call is first held bit-equal to the plain version on the card.
Device time: the median of 5 replays of a CUDA graph of ten calls whose
inputs rotate (so the L2 cache starts cold), in ms per call; host: the
wall of 200 calls without a synchronise.  To compare two trees, run the
same command from both in turns on one card.  Prints one JSON line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

from .timing import graph_ms

TAPS = {
    2: (0.05, 1.6, -0.65),  # poles 0.8 +- 0.1j
    # poles at radii 0.95, 0.9, 0.85, 0.8, unit gain at DC (chip_smoke)
    8: (0.3017025, 1.7045681, -1.5572132, 1.1628689, -0.8696898, 0.672317,
        -0.5769415, 0.500414, -0.33802596),
    32: (1.0,) + (0.95 / 32,) * 32,  # the general (predicated) form
}


def passes_us(fn, calls: int = 10) -> dict:
    """Each kernel's mean device µs a call, by name, over ``calls``
    calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"\b(iir_\w+)<", e.key)
        if e.device_time_total > 0 and name:
            out[name.group(1)] = e.device_time_total / calls
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("time_iir: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.utils import stats

    dev = torch.device("cuda")
    peaks = stats.card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": argv[1] if len(argv) > 1 else "", "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    for n in (1 << 14, 1 << 24):
        xs = [torch.randn(n, generator=gen, device=dev) for _ in range(4)]
        for order, taps in TAPS.items():
            h = torch.zeros(order, device=dev)
            same = torch.equal(kernels.iir_scan(xs[0], taps, h),
                               kernels.iir_scan_plain(xs[0], taps, h))
            ms = graph_ms(lambda k: kernels.iir_scan(xs[k % len(xs)], taps, h))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kernels.iir_scan(xs[0], taps, h)
            host = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            bound = stats.bound_ms(*kernels.iir_work(n, order), *peaks)
            out[f"G order {order}, {n}"] = {
                "bit_equal_plain": same, "device_ms": ms, "host_us": host,
                "bound_ms": bound[0], "bound_by": bound[1],
                "share": bound[0] / ms,
                "passes_us": passes_us(lambda: kernels.iir_scan(xs[0], taps, h))}
        del xs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
