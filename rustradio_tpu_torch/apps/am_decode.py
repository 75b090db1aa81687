"""AM receiver: IQ capture -> demodulated audio file (port of
``rustradio_tpu/apps/am_decode.py``; reference examples/airspy_am_decode.rs).

Accepts complex64 IQ (-f c32) or the AirSpy packed u32 format where each
word holds 16-bit I in the low half and 16-bit Q in the high half.  The
capture is processed on ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain versions): ``models.fm.am_rx``, its channel filter
on kernel A.

Usage:
    python -m rustradio_tpu_torch.apps.am_decode -r capture.c32 \
        --sample_rate 192k -o audio.f32
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..dtypes import parse_frequency
from . import add_device_arg, parse_device
from ..io import au, rawfile
from ..models.fm import am_rx


def airspy_decode(raw: np.ndarray) -> np.ndarray:
    """Packed u32 -> complex64 (examples/airspy_am_decode.rs:55-59)."""
    raw = np.asarray(raw, np.uint32)
    i = (raw & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.float32)
    q = ((raw >> 16) & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.float32)
    return ((i + 1j * q) / 1000.0).astype(np.complex64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="IQ capture file")
    p.add_argument("-o", "--out", required=True, help="output audio (.f32 or .au)")
    p.add_argument("-f", "--format", choices=["c32", "airspy"], default="c32")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("--audio_rate", type=parse_frequency, default=48_000.0)
    p.add_argument("--volume", type=float, default=1.0)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    if opt.format == "airspy":
        iq = airspy_decode(np.fromfile(opt.read, np.uint32))
    else:
        iq = rawfile.read_samples(opt.read, "c32")
    t0 = time.time()
    audio = am_rx(iq, float(opt.sample_rate), float(opt.audio_rate), opt.volume,
                  device=device).cpu().numpy()
    dt = time.time() - t0
    if opt.out.endswith(".au"):
        with open(opt.out, "wb") as f:
            f.write(au.au_encode(audio, int(opt.audio_rate)))
    else:
        rawfile.write_samples(opt.out, audio, "f32")
    rate = len(iq) / dt / 1e6 if dt > 0 else float("inf")
    print(f"demodulated {len(iq)} samples -> {len(audio)} audio samples "
          f"in {dt:.2f}s ({rate:.1f} Msamples/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
