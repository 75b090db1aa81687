"""AX.25 9600 bd G3RUH receiver, traditional symbol-sync path (port of
``rustradio_tpu/apps/ax25_9600_rx.py``; reference examples/ax25-9600-rx.rs).

Usage:
    python -m rustradio_tpu_torch.apps.ax25_9600_rx -r capture.c32 \
        --sample_rate 300k -o packets/

The capture is processed on ``--device`` (default ``cuda``); without a
card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..dtypes import parse_frequency
from ..io import rawfile
from ..models.ax25 import ax25_9600_rx, parse_ax25
from . import add_device_arg, parse_device


def read_capture(path: str, device) -> torch.Tensor:
    """A complex64 IQ file as a tensor on ``device``."""
    return torch.from_numpy(rawfile.read_samples(path, "c32")).to(device)


def write_packets(out_dir: str, pkts) -> None:
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    for i, pkt in enumerate(pkts):
        with open(os.path.join(out_dir, f"{stamp}.{i:06d}"), "wb") as f:
            f.write(bytes(pkt))


def print_packets(pkts) -> None:
    for pkt in pkts:
        addrs, info = parse_ax25(pkt.data)
        route = ">".join(addrs[:2][::-1]) if len(addrs) >= 2 else "?"
        print(f"{route}: {info[:100]!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="complex64 IQ file")
    p.add_argument("-o", "--out", help="directory to write packets to")
    p.add_argument("--sample_rate", type=parse_frequency, default=300_000.0)
    p.add_argument(
        "--symbol_taps", default="0.0001,0.99999999",
        help="clock filter taps, comma separated",
    )
    p.add_argument("--symbol_max_deviation", type=float, default=0.1)
    p.add_argument("--fix_bits", action="store_true")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    iq = read_capture(opt.read, device)
    taps = tuple(float(t) for t in opt.symbol_taps.split(","))
    t0 = time.time()
    pkts = ax25_9600_rx(
        iq, float(opt.sample_rate),
        symbol_taps=taps,
        symbol_max_deviation=opt.symbol_max_deviation,
        fix_bits=opt.fix_bits,
    )
    dt = time.time() - t0
    if opt.out:
        write_packets(opt.out, pkts)
    print_packets(pkts)
    print(f"decoded {len(pkts)} packets in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
