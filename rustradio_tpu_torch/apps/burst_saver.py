"""Burst saver: listen for power bursts, save each as a separate IQ file
(port of ``rustradio_tpu/apps/burst_saver.py``; reference
examples/burst_saver.rs).

Usage:
    python -m rustradio_tpu_torch.apps.burst_saver -r capture.c32 \
        --sample_rate 300k -o bursts/

The capture is processed on ``--device`` (default ``cuda``); without a
card, pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import taps as tapgen
from ..dtypes import parse_frequency
from ..io import rawfile
from ..models.ax25 import _stream
from ..ops.burst import burst_tagger, stream_to_pdu
from ..ops.delay import delay as delay_op
from ..ops.elementwise import complex_to_mag2
from ..ops.fft_filter import filter_complex
from ..ops.iir import single_pole_iir
from ..ops.resampler import rational_resampler
from . import add_device_arg, parse_device
from .ax25_9600_rx import read_capture


def extract_bursts(
    iq,
    samp_rate: float,
    new_rate: float = 50_000.0,
    iir_alpha: float = 0.01,
    threshold: float = 0.0001,
    delay: int = 3000,
    tail: int = 5000,
    device=None,
) -> list:
    """Channel filter -> resample -> power-gate with pre-trigger delay ->
    segment extraction (reference examples/burst_saver.rs:90-126).  ``iq``
    is a tensor (it stays on its device) or a numpy array with
    ``device=``; the bursts are complex64 tensors on that device."""
    iq = _stream(iq, torch.complex64, device)
    lp = tapgen.low_pass_complex(samp_rate, 20_000.0, 100.0, "hamming")
    x = filter_complex(iq, lp)
    x = rational_resampler(x, int(new_rate), int(samp_rate))
    power = single_pole_iir(complex_to_mag2(x), iir_alpha)
    # the reference delays the data path so the burst start isn't clipped
    data = delay_op(x, delay)
    n = min(len(data), int(power.shape[0]))
    start, end = burst_tagger(power[:n], threshold)
    return stream_to_pdu(data[:n], start, end, int(new_rate), tail)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="complex64 IQ file")
    p.add_argument("-o", "--out", required=True, help="output directory")
    p.add_argument("--sample_rate", type=parse_frequency, default=300_000.0)
    p.add_argument("--threshold", type=float, default=0.0001)
    p.add_argument("--iir_alpha", type=float, default=0.01)
    p.add_argument("--delay", type=int, default=3000)
    p.add_argument("--tail", type=int, default=5000)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    iq = read_capture(opt.read, device)
    t0 = time.time()
    bursts = extract_bursts(
        iq, float(opt.sample_rate),
        iir_alpha=opt.iir_alpha, threshold=opt.threshold,
        delay=opt.delay, tail=opt.tail,
    )
    dt = time.time() - t0
    os.makedirs(opt.out, exist_ok=True)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    for i, burst in enumerate(bursts):
        rawfile.write_samples(
            os.path.join(opt.out, f"{stamp}.{i:06d}.c32"), burst.cpu().numpy(), "c32"
        )
    print(f"saved {len(bursts)} bursts in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
