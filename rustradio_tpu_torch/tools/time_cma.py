"""Kernel F alone, on one NVIDIA GPU: its device time at the held window
(2^14 windows) and at the main path's call (2^22 windows) with 16 taps,
and at 2^14 windows with 40 and 128 taps; cycles a window at the SM clock
that ``time_sync.calibrate`` measures, the share of its bytes bound and of
its longest dependent chain (``kernels.cma_chain_links``).

    python -m rustradio_tpu_torch.tools.time_cma [label]

Each 2^14-window call is first held bit-equal to the plain version on the
card.  Device time: the median of 5 CUDA-event timings (3 at 2^22) of one
launch.  To compare two trees, run the same command from both in turns
on one card.  Prints one JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

SHAPES = ((16, 1 << 14), (16, 1 << 22), (40, 1 << 14), (128, 1 << 14))
MU = 1e-3


def station(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Unit-modulus FM-like samples through a pre-echo two samples ahead
    plus noise of 0.01, as chip_smoke's phase 14 feeds kernel F."""
    ph = torch.cumsum(torch.randn(n + 2, generator=gen, device=dev,
                                  dtype=torch.float64) * 0.3, 0)
    s = torch.polar(torch.ones_like(ph), ph)
    noise = torch.randn((2, n), generator=gen, device=dev, dtype=torch.float64)
    return (s[:n] + 0.3 * np.exp(0.7j) * s[2:]
            + 0.01 * torch.complex(noise[0], noise[1])).to(torch.complex64)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("time_cma: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.tools import time_sync
    from rustradio_tpu_torch.utils import stats

    dev = torch.device("cuda")
    peaks = stats.card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    cal = time_sync.calibrate(dev)
    out = {"label": argv[1] if len(argv) > 1 else "", "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
           "sm_ghz": cal["sm_hz"] / 1e9, "fadd_cycles": cal["fadd_cycles"],
           "shfl_add_cycles": cal["shfl_add_cycles"]}
    for ntaps, nwin in SHAPES:
        x = station(nwin + ntaps - 1, gen, dev)
        t0 = torch.zeros(ntaps, dtype=torch.complex64, device=dev)
        t0[0] = 1.0
        row = {}
        if nwin <= 1 << 14:
            y, fin = kernels.cma_scan(x, t0, 1.0, MU)
            py, pfin = kernels.cma_scan_plain(x, t0, 1.0, MU)
            row["bit_equal_plain"] = (torch.equal(y, py) and torch.equal(fin, pfin))
        kernels.cma_scan(x, t0, 1.0, MU)
        times = []
        for _ in range(3 if nwin > 1 << 14 else 5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            kernels.cma_scan(x, t0, 1.0, MU)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        ms = statistics.median(times)
        bound = stats.bound_ms(*kernels.cma_work(x.shape[0], ntaps), *peaks)
        links, shuffles = kernels.cma_chain_links(nwin, ntaps)
        chain = (links * cal["fadd_cycles"] + shuffles * cal["shfl_add_cycles"]
                 ) / cal["sm_hz"] * 1e3
        row.update(device_ms=ms, cycles_a_window=ms * 1e-3 * cal["sm_hz"] / nwin,
                   bound_ms=bound[0], bound_by=bound[1], bound_share=bound[0] / ms,
                   chain_ms=chain, chain_share=chain / ms)
        out[f"F {ntaps} taps, {nwin} windows"] = row
        del x
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
