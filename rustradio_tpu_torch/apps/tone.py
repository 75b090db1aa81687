"""Generate a test tone to a raw sample file (port of
``rustradio_tpu/apps/tone.py``; reference examples/tone.rs /
simple_graph.rs): ``ops.signal_source_c`` (or ``_f`` with ``--real``) on
``--device`` (default ``cuda``; ``--device cpu`` without a card).

Usage:
    python -m rustradio_tpu_torch.apps.tone --freq 1k --sample_rate 48k \
        --seconds 1 --out tone.c32
"""

from __future__ import annotations

import argparse
import sys

from ..dtypes import parse_frequency
from ..io import rawfile
from ..ops.signal import signal_source_c, signal_source_f
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--freq", type=parse_frequency, default=1000.0)
    p.add_argument("--sample_rate", type=parse_frequency, default=48000.0)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--amplitude", type=float, default=0.5)
    p.add_argument("--real", action="store_true", help="write f32 instead of c32")
    p.add_argument("--out", required=True)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    n = int(opt.sample_rate * opt.seconds)
    gen = signal_source_f if opt.real else signal_source_c
    y = gen(n, opt.sample_rate, opt.freq, opt.amplitude, device=device)
    rawfile.write_samples(opt.out, y.cpu().numpy())
    print(f"wrote {n} samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
