"""AX.25 1200 bd Bell-202 receiver (port of
``rustradio_tpu/apps/ax25_1200_rx.py``; reference examples/ax25-1200-rx.rs).

Usage:
    python -m rustradio_tpu_torch.apps.ax25_1200_rx --audio -r capture.au \
        --sample_rate 44100 -o packets/
    python -m rustradio_tpu_torch.apps.ax25_1200_rx -r capture.c32 \
        --sample_rate 50k -o packets/
    python -m rustradio_tpu_torch.apps.ax25_1200_rx -r capture.sigmf-meta

Input: ``.au`` audio (``--audio``), a SigMF recording (``.sigmf``,
``.sigmf-meta`` or ``.sigmf-data``; its sample rate unless
``--sample_rate`` overrides it) or raw complex64 IQ (``--sample_rate``
required).  The capture is processed on ``--device`` (default ``cuda``);
without a card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..dtypes import parse_frequency
from ..io import au, rawfile, sigmf
from ..models.ax25 import ax25_1200_rx, ax25_1200_rx_iq
from . import add_device_arg, parse_device
from .ax25_9600_rx import print_packets, write_packets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--audio", action="store_true", help="input is .au audio")
    p.add_argument("-r", "--read", required=True, help="input file")
    p.add_argument("-o", "--out", help="directory to write packets to")
    p.add_argument("--sample_rate", type=parse_frequency, default=None)
    p.add_argument("--fix_bits", action="store_true")
    p.add_argument(
        "--symbol_taps", default="0.5,0.5", help="clock filter taps, comma separated"
    )
    p.add_argument("--symbol_max_deviation", type=float, default=0.5)
    p.add_argument(
        "--demod", choices=["discriminator", "tones"], default="discriminator",
        help="audio demod: reference discriminator chain or the more "
        "sensitive dual-tone correlator",
    )
    p.add_argument(
        "--keep_checksum", action="store_true",
        help="emit frames without CRC verification (structural recovery)",
    )
    p.add_argument(
        "--sync", choices=["native", "events"], default="native",
        help="clock recovery: bit-exact sequential recurrence on the host or "
        "the event-driven form on the device (~sps-times shorter chain)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    taps = tuple(float(t) for t in opt.symbol_taps.split(","))
    kw = dict(fix_bits=opt.fix_bits, symbol_taps=taps,
              symbol_max_deviation=opt.symbol_max_deviation, demod=opt.demod,
              keep_checksum=opt.keep_checksum, sync=opt.sync)
    t0 = time.time()
    if opt.audio:
        audio, rate = au.au_read(opt.read,
                                 int(opt.sample_rate) if opt.sample_rate else None)
        pkts = ax25_1200_rx(torch.from_numpy(audio).to(device), float(rate), **kw)
    else:
        if opt.read.endswith((".sigmf", ".sigmf-meta", ".sigmf-data")):
            iq, meta = sigmf.read(opt.read, opt.sample_rate)
            rate = meta.global_.sample_rate
            if rate is None:
                print("SigMF file does not specify sample rate", file=sys.stderr)
                return 1
        else:
            if opt.sample_rate is None:
                print("raw IQ input requires --sample_rate", file=sys.stderr)
                return 1
            iq = rawfile.read_samples(opt.read, "c32")
            rate = opt.sample_rate
        pkts = ax25_1200_rx_iq(torch.from_numpy(iq).to(device), float(rate), **kw)
    dt = time.time() - t0

    if opt.out:
        write_packets(opt.out, pkts)
    print_packets(pkts)
    print(f"decoded {len(pkts)} packets in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
