"""Narrow-band FM receiver (port of ``rustradio_tpu/apps/rtl_fm.py``;
reference examples/rtl_fm.rs): capture or SDR -> channel filter -> FM
demod -> audio resample -> .au.

Usage:
    python -m rustradio_tpu_torch.apps.rtl_fm -r capture.c32 \
        --sample_rate 1.024m --out audio.au
    python -m rustradio_tpu_torch.apps.rtl_fm -r capture.u8 --rtl_u8 \
        --precision i8 --out audio.au
    python -m rustradio_tpu_torch.apps.rtl_fm -r sim --seconds 2 --out audio.au

A c32 capture, ``-r sim`` (the loopback ``hw.SimDriver``: one FM carrier
at the tuned frequency, or ``--sim_tone`` tones) and ``-r rtl[:index]``
(a live RTL-SDR through pyrtlsdr) take ``ops.filter_complex`` (kernel A)
-> ``quadrature_demod`` -> ``rational_resampler``; ``--rtl_u8`` (capture
files only) takes the whole filter + demod as one kernel B pass
(``fm_demod_chain_planar``, ``--precision w3|i8``).  The samples are
processed on ``--device`` (default ``cuda``); without a card, pass
``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import taps as tapgen
from ..dtypes import parse_frequency
from . import add_device_arg, parse_device
from ..io import au, rawfile
from ..models.fm import fm_demod_chain_planar
from ..ops.demod import quadrature_demod
from ..ops.fft_filter import filter_complex
from ..ops.resampler import rational_resampler


def live_capture(p: argparse.ArgumentParser, opt, device) -> torch.Tensor:
    """``--seconds`` of samples from ``-r sim`` or ``-r rtl[:index]``
    through an ``SdrSource``, on ``device``; its tags go to stderr."""
    from ..hw import RtlDriver, SdrSource
    from ..hw.driver import sim_driver

    if opt.read == "sim":
        drv = sim_driver(opt.frequency, opt.sample_rate, opt.sim_tone,
                         [(opt.frequency, 0.8, 1_000.0, opt.deviation / 2)])
    else:
        idx_s = opt.read.split(":", 1)[1] if ":" in opt.read else ""
        try:
            idx = int(idx_s) if idx_s else 0
        except ValueError:
            p.error(f"bad rtl device spec {opt.read!r}: want rtl or rtl:<index>")
        drv = RtlDriver(
            frequency=float(opt.frequency),
            sample_rate=float(opt.sample_rate),
            gain=1.0,
            device_index=idx,
        )
    src = SdrSource(drv)
    iq = src.emit(0, int(opt.seconds * opt.sample_rate), device)
    for t in src.emit_tags(0, iq.shape[0]):
        print(f"tag {t.key} = {t.val}", file=sys.stderr)
    drv.close()
    return iq


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True,
                   help="IQ capture file, 'sim' for the loopback SDR driver, "
                        "or 'rtl[:index]' for a live RTL-SDR via pyrtlsdr")
    p.add_argument("--sample_rate", type=parse_frequency, default=1_024_000.0)
    p.add_argument("--audio_rate", type=parse_frequency, default=48_000.0)
    p.add_argument("--cutoff", type=parse_frequency, default=100_000.0)
    p.add_argument("--deviation", type=parse_frequency, default=75_000.0)
    p.add_argument("--volume", type=float, default=1.0)
    p.add_argument("--out", required=True, help=".au output file")
    p.add_argument("--rtl_u8", action="store_true", help="input is RTL-SDR u8 IQ")
    p.add_argument("--precision", choices=["w3", "i8"], default="w3",
                   help="--rtl_u8 kernel-B precision: 'w3' bf16-exact planes, "
                        "'i8' int8 planes (exact on the u8 wire grid)")
    p.add_argument("--frequency", type=parse_frequency, default=100_000_000.0,
                   help="sim/rtl mode: tuner center frequency")
    p.add_argument("--sim_tone", action="append", default=[],
                   help="sim mode: FREQ:AMP[:AUDIO:DEV] RF tone (repeatable)")
    p.add_argument("--seconds", type=float, default=1.0,
                   help="sim/rtl mode: capture length")
    add_device_arg(p)
    opt = p.parse_args(argv)

    is_live = opt.read == "sim" or opt.read == "rtl" or opt.read.startswith("rtl:")
    if is_live and opt.rtl_u8:
        p.error("--rtl_u8 applies to capture files, not sim/rtl live input")
    device = parse_device(p, opt.device)

    fs, ar = float(opt.sample_rate), float(opt.audio_rate)
    cutoff, gain = float(opt.cutoff), fs / (2 * np.pi * float(opt.deviation))
    if opt.rtl_u8:
        raw = np.fromfile(opt.read, np.uint8)
        # the raw planes on the (u8 - 127)/128 wire grid: exact in bf16 (w3)
        # and the s8 image the i8 kernel expects; the demod is
        # scale-invariant, so the normalization is free
        pairs = raw[: len(raw) // 2 * 2].reshape(-1, 2).astype(np.float32)
        i_pl, q_pl = ((pairs[:, k] - 127.0) / 128.0 for k in (0, 1))
        demod = fm_demod_chain_planar(i_pl, q_pl, fs, cutoff, cutoff / 2,
                                      deci=1, gain=gain,
                                      precision=opt.precision, device=device)
    else:
        iq = (live_capture(p, opt, device) if is_live else
              torch.from_numpy(rawfile.read_samples(opt.read, "c32")).to(device))
        lp = tapgen.low_pass_complex(fs, cutoff, cutoff / 2, "hamming")
        demod = quadrature_demod(filter_complex(iq, lp), gain)
    audio = rational_resampler(demod, int(ar), int(fs)).cpu().numpy()
    audio = audio * opt.volume
    with open(opt.out, "wb") as f:
        f.write(au.au_encode(np.clip(audio, -1, 1), int(ar)))
    print(f"wrote {len(audio)} audio samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
