"""Device time of kernels A and B alone, at the shapes of the FM chain and
of the AX.25 front-end, on one NVIDIA GPU.

    python -m rustradio_tpu_torch.tools.time_fir [label]

Each time is the median of 5 replays of a CUDA graph of ten calls whose
inputs rotate (so the L2 cache starts cold), in ms per call.  It measures
the package it is run from: to compare two trees, unpack the other into a
directory, run the same command from both in turns on one card, one after
the other, and compare only those.  Prints one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from .timing import graph_ms


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("time_fir: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rustradio_tpu_torch import taps as tapgen
    from rustradio_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lp49 = kernels.tapset(np.real(tapgen.low_pass_complex(
        1_024_000.0, 100_000.0, 50_000.0, "hamming")).astype(np.float32))
    out = {"label": argv[1] if len(argv) > 1 else "", "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}

    n = 1 << 24
    grid = [(torch.randint(0, 256, (n,), generator=gen, device=dev).float()
             - 127.0) / 128.0 for _ in range(2)]
    for precision in ("w3", "i8"):
        planes = [[kernels.fm_plane_pack(p, lp49, 4, None, precision)
                   for p in grid]]
        planes += [[p.clone() for p in planes[0]] for _ in range(2)]

        def run(k, planes=planes, precision=precision):
            a, b = planes[k % len(planes)]
            kernels.fm_chain(a, b, lp49, 4, precision=precision, n=n)

        out[f"B packed {precision} 2^24, 49 taps, deci 4"] = graph_ms(run)
        del planes
    del grid
    for ntaps, deci, length in ((49, 4, 1 << 22), (1205, 1, 1 << 22),
                                (65, 1, 14_308_087), (289, 1, 14_308_087)):
        taps = lp49 if ntaps == 49 else kernels.tapset(
            np.random.RandomState(ntaps).randn(ntaps).astype(np.float32))
        xs = [torch.randn(length, generator=gen, device=dev) for _ in range(4)]
        out[f"A {ntaps} taps, deci {deci}, {length}"] = graph_ms(
            lambda k: kernels.fir_decimate(xs[k % len(xs)], taps, deci))
        del xs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
