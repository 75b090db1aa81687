"""Terminal waterfall/spectrum of a capture (port of
``rustradio_tpu/apps/spectrum.py``; the reference's rtl_fm ratatui
waterfall, examples/rtl_fm.rs:81-120, as a standalone viewer): raw c32 or
SigMF in, ``utils.waterfall.spectrogram`` on ``--device`` (default
``cuda``; ``--device cpu`` without a card), ASCII out.

Usage:
    python -m rustradio_tpu_torch.apps.spectrum -r capture.c32 --sample_rate 1m
"""

from __future__ import annotations

import argparse
import sys

from ..dtypes import parse_frequency
from ..io import rawfile, sigmf
from ..utils.waterfall import render_ascii, spectrogram
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True)
    p.add_argument("--sample_rate", type=parse_frequency, default=None)
    p.add_argument("--fft_size", type=int, default=1024)
    p.add_argument("--width", type=int, default=100)
    p.add_argument("--height", type=int, default=30)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    if opt.read.endswith((".sigmf", ".sigmf-meta", ".sigmf-data")):
        x, meta = sigmf.read(opt.read, opt.sample_rate)
        rate = meta.global_.sample_rate
    else:
        x = rawfile.read_samples(opt.read, "c32")
        rate = opt.sample_rate
    db = spectrogram(x, opt.fft_size, device=device).cpu().numpy()
    print(render_ascii(db, opt.width, opt.height))
    if rate:
        print(f"span: {-rate/2e3:.0f} kHz ... +{rate/2e3:.0f} kHz, "
              f"{len(x)/rate:.2f} s, {db.shape[0]} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
