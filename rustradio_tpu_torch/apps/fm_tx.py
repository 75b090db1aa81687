"""FM transmitter: audio file -> FM-modulated IQ (port of
``rustradio_tpu/apps/fm_tx.py``; reference examples/fm_tx.rs): the audio
held up to the IQ rate (``ops.rational_resampler``) and modulated by
``ops.vco`` on ``--device`` (default ``cuda``; ``--device cpu`` without a
card).  The VCO sums its phase in float64 (``ops/vco.py``).

Usage:
    python -m rustradio_tpu_torch.apps.fm_tx -r audio.au --deviation 5k \
        --sample_rate 240k --out fm.c32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..dtypes import parse_frequency
from ..io import au, rawfile
from ..ops.resampler import rational_resampler
from ..ops.vco import vco
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help=".au audio in")
    p.add_argument("--sample_rate", type=parse_frequency, default=240_000.0)
    p.add_argument("--deviation", type=parse_frequency, default=75_000.0)
    p.add_argument("--out", required=True, help=".c32 IQ out")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    audio, rate = au.au_read(opt.read)
    a = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    up = rational_resampler(a, int(float(opt.sample_rate)), int(float(rate)))
    iq, _ = vco(up, k=2 * np.pi * float(opt.deviation) / float(opt.sample_rate))
    rawfile.write_samples(opt.out, iq.cpu().numpy())
    print(f"wrote {iq.shape[0]} IQ samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
