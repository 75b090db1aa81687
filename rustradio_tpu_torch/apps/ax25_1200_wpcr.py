"""AX.25 1200 bd AFSK burst receiver with whole-packet clock recovery (port
of ``rustradio_tpu/apps/ax25_1200_wpcr.py``; reference
examples/ax25-1200-wpcr.rs).

Usage:
    python -m rustradio_tpu_torch.apps.ax25_1200_wpcr -r aprs-50k.c32 \
        --sample_rate 50k -o packets/

The capture is processed on ``--device`` (default ``cuda``); without a
card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..dtypes import parse_frequency
from ..models.ax25 import ax25_1200_wpcr_rx
from ..ops import hdlc
from ..ops.wpcr import TOTALS as BURSTS, prewarm_buckets
from . import add_device_arg, parse_device
from .ax25_9600_rx import print_packets, read_capture, write_packets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="complex64 IQ file")
    p.add_argument("-o", "--out", help="directory to write packets to")
    p.add_argument("--sample_rate", type=parse_frequency, default=50_000.0)
    p.add_argument("--threshold", type=float, default=0.0001)
    p.add_argument("--iir_alpha", type=float, default=0.01)
    p.add_argument("--fix_bits", action="store_true")
    p.add_argument(
        "--no_prewarm", action="store_true",
        help="skip making the WPCR buckets' FFT plans at startup (made "
        "while the capture is read, so that the first burst finds them)",
    )
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    if not opt.no_prewarm:
        prewarm_buckets(batches=(1, 2, 4), device=device)

    iq = read_capture(opt.read, device)
    bursts0, crc0 = dict(BURSTS), hdlc.TOTALS["crc_error"]
    t0 = time.time()
    pkts = ax25_1200_wpcr_rx(
        iq, float(opt.sample_rate),
        threshold=opt.threshold, iir_alpha=opt.iir_alpha,
        fix_bits=opt.fix_bits,
    )
    dt = time.time() - t0
    if opt.out:
        write_packets(opt.out, pkts)
    print_packets(pkts)
    b = {k: v - bursts0[k] for k, v in BURSTS.items()}
    print(f"decoded {len(pkts)} packets from {b['bursts']} bursts "
          f"({b['too_long']} too long, {b['found']} clock found, "
          f"{hdlc.TOTALS['crc_error'] - crc0} CRC failures) in {dt:.2f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
