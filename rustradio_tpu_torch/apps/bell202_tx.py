"""Bell-202 AFSK transmitter: AX.25 payloads -> .au audio (port of
``rustradio_tpu/apps/bell202_tx.py``; the TX half of reference
examples/bell202.rs).

Usage:
    echo 'APRS test' | python -m rustradio_tpu_torch.apps.bell202_tx \
        --src N0CALL --dst APRS --out out.au

Each line of the standard input becomes one AX.25 UI frame, framed (FCS,
HDLC) on the host; the NRZI line and its tones are made on ``--device``
(default ``cuda``; without a card, pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from ..io import au
from ..ops.hdlc import fcs_add, hdlc_frame
from ..ops.nrzi import nrzi_encode
from . import add_device_arg, parse_device


def make_ax25_ui(dst: str, src: str, info: bytes) -> np.ndarray:
    def addr(call: str, ssid: int, last: bool):
        call = call.ljust(6)[:6]
        b = [ord(c) << 1 for c in call]
        b.append(((ssid & 0xF) << 1) | 0x60 | (1 if last else 0))
        return b

    def split(c):
        if "-" in c:
            base, ssid = c.rsplit("-", 1)
            return base, int(ssid)
        return c, 0

    d, dssid = split(dst)
    s, sssid = split(src)
    frame = addr(d, dssid, False) + addr(s, sssid, True) + [0x03, 0xF0] + list(info)
    return np.asarray(frame, np.uint8)


def afsk_modulate(line_bits: torch.Tensor, fs: float, baud: float = 1200.0,
                  mark: float = 1200.0, space: float = 2200.0,
                  amp: float = 0.5) -> torch.Tensor:
    """Phase-continuous AFSK of a line-bit tensor, f32 on its device: the
    tone of each sample's bit, its phase summed in float64 as the JAX
    package's numpy does."""
    sps = fs / baud
    n = int(len(line_bits) * sps)
    k = torch.arange(n, dtype=torch.float64, device=line_bits.device)
    bit_at = torch.clamp((k / sps).long(), max=len(line_bits) - 1)
    freqs = torch.where(line_bits[bit_at] == 1, mark, space).to(torch.float64)
    phase = torch.cumsum(2 * math.pi * freqs / fs, 0)
    return (amp * torch.sin(phase)).to(torch.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src", required=True, help="source callsign")
    p.add_argument("--dst", default="APRS")
    p.add_argument("--sample_rate", type=float, default=44100.0)
    p.add_argument("--out", required=True)
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    chunks = []
    gap = torch.zeros(int(opt.sample_rate * 0.1), dtype=torch.float32, device=device)
    for line in sys.stdin.read().splitlines():
        frame = make_ax25_ui(opt.dst, opt.src, line.encode())
        bits = torch.from_numpy(hdlc_frame(fcs_add(frame))).to(device)
        chunks += [afsk_modulate(nrzi_encode(bits), opt.sample_rate), gap]
    audio = (torch.cat(chunks).cpu().numpy() if chunks
             else np.zeros(0, np.float32))
    with open(opt.out, "wb") as f:
        f.write(au.au_encode(audio, int(opt.sample_rate)))
    print(f"wrote {len(audio)} samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
