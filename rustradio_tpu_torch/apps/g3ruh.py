"""G3RUH 9600 bd AX.25 modem speaking KISS (port of
``rustradio_tpu/apps/g3ruh.py``; reference examples/g3ruh.rs).

The reference drives a SoapySDR device full-duplex; here the modem's RF
side is file/TCP IQ:

* RX: decode complex64 IQ (``-r`` file) with either the traditional
  symbol-sync path or WPCR (``--wpcr``), and emit each decoded frame as a
  KISS frame to the connected client (or stdout).
* TX: KISS frames received from the client (or a file via ``--tx_in``) are
  G3RUH-modulated to complex64 baseband written to ``--tx_out``.

Usage:
    python -m rustradio_tpu_torch.apps.g3ruh -r rx.c32 --sample_rate 300k \
        --tcp_listen 127.0.0.1:7878 --tx_out tx.c32

Both directions run on ``--device`` (default ``cuda``); without a card,
pass ``--device cpu`` (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np

from ..blocks.packets import KISS_FEND, KissDecode, KissEncode, KissFrame
from ..dtypes import parse_frequency
from ..io import rawfile
from ..models.ax25 import ax25_9600_rx, ax25_9600_wpcr_rx, g3ruh_modulate
from ..streams import Pdu
from . import add_device_arg, parse_device
from .ax25_9600_rx import read_capture


def kiss_encode_frame(frame: np.ndarray) -> bytes:
    out = KissEncode().apply([Pdu(np.asarray(frame, np.uint8), [])])
    return bytes(out[0].data)


def kiss_decode_stream(data: bytes) -> list[np.ndarray]:
    """KISS byte stream -> frames, via the block pair (KissFrame
    accumulates between FENDs, KissDecode unescapes — reference
    src/kiss.rs)."""
    # KissFrame expects a leading FEND sync; sender streams start with one
    stream = np.frombuffer(bytes([KISS_FEND]) + data, np.uint8)
    frames = KissFrame().apply(stream)
    return [np.asarray(p.data, np.uint8) for p in KissDecode().apply(frames)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", help="complex64 IQ file to receive from")
    p.add_argument("--sample_rate", type=parse_frequency, default=300_000.0)
    p.add_argument("--wpcr", action="store_true", help="use WPCR instead of SymbolSync")
    p.add_argument("--tcp_listen", help="host:port to await one KISS client on")
    p.add_argument("--tx_in", help="file of KISS frames to transmit")
    p.add_argument("--tx_out", help="write modulated complex64 baseband here")
    p.add_argument("--symbol_max_deviation", type=float, default=0.1)
    p.add_argument(
        "--symbol_taps", default="1",
        help="clock filter taps, comma separated (reference g3ruh.rs default)",
    )
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    conn = None
    if opt.tcp_listen:
        host, port = opt.tcp_listen.rsplit(":", 1)
        with socket.create_server((host, int(port))) as srv:
            print(f"awaiting KISS connection on {opt.tcp_listen}", file=sys.stderr)
            conn, addr = srv.accept()
        print(f"connect from {addr}", file=sys.stderr)

    try:
        # Receive: IQ file -> AX.25 frames -> KISS out.
        if opt.read:
            iq = read_capture(opt.read, device)
            t0 = time.time()
            if opt.wpcr:
                pkts = ax25_9600_wpcr_rx(iq, float(opt.sample_rate))
            else:
                taps = tuple(float(t) for t in opt.symbol_taps.split(","))
                pkts = ax25_9600_rx(
                    iq, float(opt.sample_rate),
                    symbol_taps=taps,
                    symbol_max_deviation=opt.symbol_max_deviation,
                )
            print(f"decoded {len(pkts)} frames in {time.time() - t0:.2f}s",
                  file=sys.stderr)
            for pkt in pkts:
                data = kiss_encode_frame(pkt.data)
                if conn is not None:
                    conn.sendall(data)
                else:
                    sys.stdout.buffer.write(data)
            sys.stdout.buffer.flush()

        # Transmit: KISS in -> modulated baseband out.
        if opt.tx_out:
            if opt.tx_in:
                with open(opt.tx_in, "rb") as f:
                    raw = f.read()
            elif conn is not None:
                # read the client's KISS frames until it closes (or
                # half-closes) the connection: no idle timeout, so
                # interactive senders work
                parts = []
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    parts.append(chunk)
                raw = b"".join(parts)
            else:
                raw = sys.stdin.buffer.read()
            frames = kiss_decode_stream(raw)
            iq = g3ruh_modulate(frames, float(opt.sample_rate), device=device)
            rawfile.write_samples(opt.tx_out, iq.cpu().numpy(), "c32")
            print(f"modulated {len(frames)} frames -> {len(iq)} samples",
                  file=sys.stderr)
    finally:
        if conn is not None:
            conn.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
