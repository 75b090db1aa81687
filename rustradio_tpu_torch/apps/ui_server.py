"""Live browser dashboard: spectrum + waterfall over HTTP (port of
``rustradio_tpu/apps/ui_server.py``; the reference's rustradio-ui browser
UI, rustradio-ui/src/lib.rs:44-62).  The spectrum rows are computed on
``--device`` (default ``cuda``; ``--device cpu`` without a card).

Usage:
    python -m rustradio_tpu_torch.apps.ui_server -r capture.c32 --sample_rate 250k
    # then open the printed URL
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..dtypes import parse_frequency
from ..io import au, rawfile
from ..ui import SpectrumFeed, UiServer
from . import add_device_arg, parse_device


def iq_chunks(path: str, fmt: str, chunk: int, loop: bool):
    if fmt == "au":
        data, _ = au.au_read(path)
        data = data.astype(np.complex64)
    elif fmt == "u8":
        data = rawfile.rtlsdr_decode(np.fromfile(path, np.uint8))
    else:
        data = rawfile.read_samples(path, "c32")
    if len(data) == 0:
        return
    if len(data) < chunk:
        # shorter than one chunk: tile it up so the feed still produces rows
        data = np.tile(data, -(-chunk // len(data)))
    while True:
        for i in range(0, len(data), chunk):
            yield data[i : i + chunk]  # final partial chunk included
        if not loop:
            return


def sdr_chunks(src, chunk: int, device):
    """Endless chunks from a live hw.SdrSource on ``device`` (commands apply
    between reads, so dashboard retunes take effect on the next chunk)."""
    off = 0
    while True:
        data = src.emit(off, chunk, device)
        if data.shape[0] == 0:
            return
        off += data.shape[0]
        yield data


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True,
                   help="capture file, or 'sim' for the live loopback SDR")
    p.add_argument("-f", "--format", choices=["c32", "u8", "au"], default="c32")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("--freq", type=parse_frequency, default=0.0, help="center frequency label")
    p.add_argument("--fft_size", type=int, default=512)
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--port", type=int, default=8450)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--once", action="store_true", help="don't loop the capture")
    p.add_argument("--sim_tone", action="append", default=[],
                   help="sim mode: FREQ:AMP[:AUDIO:DEV] RF tone (repeatable)")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    chunk = max(int(opt.sample_rate / 4), opt.fft_size)
    control = None
    if opt.read == "sim":
        from ..hw import SdrSource, SimDriver
        from ..hw.driver import parse_sim_tone

        center = float(opt.freq) or 100e6
        tones = [parse_sim_tone(s) for s in opt.sim_tone] or [
            (center + 0.1 * opt.sample_rate, 0.6),
            (center - 0.25 * opt.sample_rate, 0.3, 1_000.0, 3_000.0),
        ]
        drv = SimDriver(
            frequency=center,
            sample_rate=float(opt.sample_rate),
            gain=1.0,
            tones=[t for t in tones if len(t) == 2],
            fm_tones=[t for t in tones if len(t) == 4],
            noise=0.02,
        )
        src = SdrSource(drv)
        control = src.control()
        chunks = sdr_chunks(src, chunk, device)
        opt.freq = center
    else:
        chunks = iq_chunks(opt.read, opt.format, chunk, not opt.once)
    feed = SpectrumFeed(
        chunks,
        samp_rate=float(opt.sample_rate),
        fft_size=opt.fft_size,
        center_freq=float(opt.freq),
        fps=opt.fps,
        device=device,
    )
    srv = UiServer(feed, host=opt.host, port=opt.port, control=control).start()
    print(f"serving on {srv.address}", file=sys.stderr)
    try:
        while feed.is_alive():
            time.sleep(0.5)
        print("capture exhausted; serving final state (Ctrl-C to exit)", file=sys.stderr)
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
