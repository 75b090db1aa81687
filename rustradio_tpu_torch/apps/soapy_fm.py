"""Broadcast FM receiver from a SoapySDR device to an .au file (port of
``rustradio_tpu/apps/soapy_fm.py``; reference examples/soapy_fm.rs).

The device is named by ``-d``: ``sim`` runs the loopback SimDriver with
an FM carrier at the tuned frequency (so the chain is testable without
hardware, like the reference's feature-gated build); ``soapy:<args>``
binds the real SoapySDR python bindings when the host has them.  The
samples go to ``--device`` (default ``cuda``; without a card, pass
``--device cpu``), where ``wbfm_rx`` runs.

Usage:
    python -m rustradio_tpu_torch.apps.soapy_fm -d sim --freq 100M -o fm.au
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..dtypes import parse_frequency
from ..io import au
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--driver", default="sim",
                   help="'sim' or 'soapy:<device args>'")
    p.add_argument("-o", "--output", required=True, help=".au output")
    p.add_argument("--freq", type=parse_frequency, default=100_000_000.0)
    p.add_argument("--gain", type=float, default=0.4,
                   help="input gain, normalized 0-1")
    p.add_argument("--volume", type=float, default=1.0)
    p.add_argument("--sample_rate", type=parse_frequency, default=1_024_000.0)
    p.add_argument("--audio_rate", type=parse_frequency, default=48_000.0)
    p.add_argument("--seconds", type=float, default=1.0)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    from ..hw import SimDriver, SoapySdrSource
    from ..models.fm import wbfm_rx

    if opt.driver == "sim":
        dev = SimDriver(
            frequency=float(opt.freq),
            sample_rate=float(opt.sample_rate),
            fm_tones=[(float(opt.freq), 0.8, 1_000.0, 75_000.0)],
            noise=0.01,
        )
    elif opt.driver.startswith("soapy:"):
        from ..hw.soapy import SoapyDriver

        dev = SoapyDriver(opt.driver[6:], float(opt.freq), float(opt.sample_rate))
    else:
        p.error("driver must be 'sim' or 'soapy:<args>'")

    src = (
        SoapySdrSource(dev, float(opt.freq), float(opt.sample_rate))
        .igain(opt.gain)
        .build()
    )
    n = int(opt.seconds * opt.sample_rate)
    iq = src.emit(0, n, device)
    for t in src.emit_tags(0, n):
        print(f"tag {t.key} = {t.val}", file=sys.stderr)

    audio = wbfm_rx(iq, float(opt.sample_rate), float(opt.audio_rate)).cpu().numpy()
    audio = audio * opt.volume
    with open(opt.output, "wb") as f:
        f.write(au.au_encode(np.clip(audio, -1, 1), int(opt.audio_rate)))
    print(f"wrote {len(audio)} audio samples to {opt.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
