"""IL2P 1200 bd receiver (port of ``rustradio_tpu/apps/il2p_1200_rx.py``;
reference examples/il2p-1200-rx.rs).

Usage:
    python -m rustradio_tpu_torch.apps.il2p_1200_rx -r il2p-50k.c32 --sample_rate 50k

The capture is processed on ``--device`` (default ``cuda``); without a
card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..dtypes import parse_frequency
from ..models.ax25 import il2p_1200_rx
from . import add_device_arg, parse_device
from .ax25_9600_rx import read_capture


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="complex64 IQ file")
    p.add_argument("--sample_rate", type=parse_frequency, default=50_000.0)
    p.add_argument("--symbol_taps", default="0.5,0.5")
    p.add_argument("--symbol_max_deviation", type=float, default=0.5)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    iq = read_capture(opt.read, device)
    taps = tuple(float(t) for t in opt.symbol_taps.split(","))
    t0 = time.time()
    headers = il2p_1200_rx(
        iq, float(opt.sample_rate),
        symbol_taps=taps, symbol_max_deviation=opt.symbol_max_deviation,
    )
    dt = time.time() - t0
    for h in headers:
        print(h.describe())
    print(f"decoded {len(headers)} IL2P headers in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
