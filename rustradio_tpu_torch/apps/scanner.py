"""Wideband channel scanner: polyphase-channelize a capture, report the
strongest channels, and optionally FM-demodulate one to audio or decode
AX.25 on every active channel (port of ``rustradio_tpu/apps/scanner.py``).

Usage:
    python -m rustradio_tpu_torch.apps.scanner -r wideband.c32 --sample_rate 2.56m
    python -m rustradio_tpu_torch.apps.scanner -r wideband.c32 --sample_rate 2.56m \
        --demod 37 --out ch37.f32
    python -m rustradio_tpu_torch.apps.scanner -r x.c32 --sample_rate 2.048m \
        -n 64 --decode --sync events
    python -m rustradio_tpu_torch.apps.scanner -r sim --sample_rate 2.048m

``-r sim`` reads ``--seconds`` from the loopback ``hw.SimDriver`` (two CW
tones, 0.2 MHz above and 0.35 MHz below the tuned frequency, unless
``--sim_tone`` names others).  The samples are processed on ``--device``
(default ``cuda``); without a card, pass ``--device cpu`` (the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..dtypes import parse_frequency
from . import add_device_arg, parse_device
from ..io import rawfile
from ..ops.kernels import PFB_MAX_CHANNELS, PFB_MIN_CHANNELS, pfb_supported
from ..parallel.channelizer import channelizer_taps, pfb_channelize_power


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True,
                   help="complex64 IQ capture, or 'sim' for the loopback driver")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("-n", "--channels", type=int, default=256,
                   help="channels: on the card a power of two in 16..1024")
    p.add_argument("--top", type=int, default=10, help="channels to report")
    p.add_argument("--demod", type=int, help="FM-demod this channel index")
    p.add_argument("--decode", action="store_true",
                   help="decode AX.25 on every active channel concurrently "
                        "(one clock-recovery launch for the whole band)")
    p.add_argument("--max_active", type=int, default=8,
                   help="--decode: channel bank size")
    p.add_argument("--sync", choices=["scan", "events"], default="scan",
                   help="--decode clock recovery: 'scan' = bit-exact "
                        "per-sample recurrence, 'events' = event-driven "
                        "(~sps-times shorter sequential chain)")
    p.add_argument("-o", "--out", help="write demodulated channel audio (.f32)")
    p.add_argument("--frequency", type=parse_frequency, default=100_000_000.0,
                   help="sim mode: tuner center frequency")
    p.add_argument("--sim_tone", action="append", default=[],
                   help="sim mode: FREQ:AMP[:AUDIO:DEV] RF tone (repeatable)")
    p.add_argument("--seconds", type=float, default=0.5,
                   help="sim mode: capture length")
    add_device_arg(p)
    opt = p.parse_args(argv)
    if opt.demod is not None:
        if not 0 <= opt.demod < opt.channels:
            p.error(f"--demod must be in [0, {opt.channels})")
        if not opt.out:
            p.error("--demod requires --out")
    device = parse_device(p, opt.device)
    if device.type == "cuda" and not pfb_supported(opt.channels, 8):
        p.error(f"-n {opt.channels}: the channelizer on the card takes a power "
                f"of two in {PFB_MIN_CHANNELS}..{PFB_MAX_CHANNELS}")

    if opt.read == "sim":
        from ..hw import SdrSource
        from ..hw.driver import sim_driver

        drv = sim_driver(opt.frequency, opt.sample_rate, opt.sim_tone,
                         [(opt.frequency + 0.2e6, 0.5),
                          (opt.frequency - 0.35e6, 0.3)])
        iq = SdrSource(drv).emit(0, int(opt.seconds * opt.sample_rate), device)
    else:
        iq = torch.from_numpy(rawfile.read_samples(opt.read, "c32")).to(device)

    if opt.decode:
        from ..models import multichannel
        from ..ops import hdlc

        band0, crc0 = dict(multichannel.TOTALS), hdlc.TOTALS["crc_error"]
        results = multichannel.decode_band_ax25(
            iq, float(opt.sample_rate), n_channels=opt.channels,
            max_active=opt.max_active, sync_method=opt.sync,
        )
        for r in results:
            for pkt in r.packets:
                route = ">".join(pkt.addresses[:2][::-1]) if pkt.addresses else "?"
                print(f"ch{r.channel:4d} {r.freq/1e3:+9.1f}k  {route}: "
                      f"{pkt.info[:80]!r}")
        band = {k: v - band0[k] for k, v in multichannel.TOTALS.items()}
        print(f"decoded {band['packets']} packets on {len(results)} channels "
              f"({band['active']} in the bank, {band['rerun']} re-run, "
              f"{hdlc.TOTALS['crc_error'] - crc0} CRC failures)", file=sys.stderr)
        return 0

    M = opt.channels
    fs = float(opt.sample_rate)
    ch, power = pfb_channelize_power(iq, channelizer_taps(M, 8), M)  # (frames, M)
    power = power.cpu().numpy()
    order = np.argsort(power)[::-1][: opt.top]
    print(f"{'chan':>5} {'freq':>12} {'power dB':>9}")
    for k in order:
        # channel k center: k*fs/M, wrapping to negative above M/2
        f = (k if k < M / 2 else k - M) * fs / M
        print(f"{k:5d} {f/1e3:10.1f}k {10*np.log10(power[k]+1e-20):9.1f}")

    if opt.demod is not None:
        col = ch[:, opt.demod]
        d = torch.conj(col[:-1]) * col[1:]
        audio = torch.atan2(d.imag, d.real).cpu().numpy()
        rawfile.write_samples(opt.out, audio, "f32")
        print(f"wrote {len(audio)} samples (channel {opt.demod}, "
              f"{fs/M/1e3:.1f} ksps) to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
