"""Morse beacon: keyed CW carrier to IQ or audio (port of
``rustradio_tpu/apps/morse_beacon.py``; reference examples/morse_beacon.rs):
``morse_encode_bits`` keys ``ops.signal_source_c`` on ``--device``
(default ``cuda``; ``--device cpu`` without a card).

Usage:
    python -m rustradio_tpu_torch.apps.morse_beacon --msg "CQ CQ DE N0CALL" \
        --wpm 20 --sample_rate 48k --out beacon.c32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..blocks.packets import morse_encode_bits
from ..dtypes import parse_frequency
from ..io import au, rawfile
from ..ops.signal import signal_source_c
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--msg", required=True)
    p.add_argument("--wpm", type=float, default=20.0)
    p.add_argument("--sample_rate", type=parse_frequency, default=48000.0)
    p.add_argument("--tone", type=parse_frequency, default=600.0)
    p.add_argument("--out", required=True, help=".c32 IQ or .au audio")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    bits = morse_encode_bits(opt.msg)
    dit_s = 1.2 / opt.wpm  # standard PARIS timing
    sps = int(opt.sample_rate * dit_s)
    key = torch.from_numpy(bits.astype(np.float32)).to(device)
    key = torch.repeat_interleave(key, sps)
    n = key.shape[0]
    iq = (signal_source_c(n, opt.sample_rate, opt.tone, 1.0, device=device)
          * key).cpu().numpy()
    if opt.out.endswith(".au"):
        with open(opt.out, "wb") as f:
            f.write(au.au_encode(iq.real * 0.8, int(opt.sample_rate)))
    else:
        rawfile.write_samples(opt.out, iq)
    print(f"wrote {n} samples ({n/opt.sample_rate:.1f}s) to {opt.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
