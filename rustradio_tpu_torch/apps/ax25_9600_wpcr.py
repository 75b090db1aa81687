"""AX.25 9600 bd G3RUH receiver with whole-packet clock recovery (port of
``rustradio_tpu/apps/ax25_9600_wpcr.py``; reference
examples/ax25-9600-wpcr.rs).

Usage:
    python -m rustradio_tpu_torch.apps.ax25_9600_wpcr -r capture.c32 \
        --sample_rate 50k -o packets/

The capture is processed on ``--device`` (default ``cuda``); without a
card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..dtypes import parse_frequency
from ..models.ax25 import ax25_9600_wpcr_rx
from ..ops.wpcr import prewarm_buckets
from . import add_device_arg, parse_device
from .ax25_9600_rx import print_packets, read_capture, write_packets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True)
    p.add_argument("-o", "--out")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("--threshold", type=float, default=0.0001)
    p.add_argument("--iir_alpha", type=float, default=0.01)
    p.add_argument("--fix_bits", action="store_true")
    p.add_argument(
        "--no_prewarm", action="store_true",
        help="skip making the WPCR buckets' FFT plans at startup (see "
        "ops.prewarm_buckets)",
    )
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    if not opt.no_prewarm:
        prewarm_buckets(batches=(1, 2, 4), device=device)

    iq = read_capture(opt.read, device)
    t0 = time.time()
    pkts = ax25_9600_wpcr_rx(
        iq, float(opt.sample_rate), threshold=opt.threshold,
        iir_alpha=opt.iir_alpha, fix_bits=opt.fix_bits,
    )
    dt = time.time() - t0
    if opt.out:
        write_packets(opt.out, pkts)
    print_packets(pkts)
    print(f"decoded {len(pkts)} packets in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
