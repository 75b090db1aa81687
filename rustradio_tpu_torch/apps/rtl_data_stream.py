"""Serve a downsampled IQ byte stream over the DATA_STREAM protocol (port of
``rustradio_tpu/apps/rtl_data_stream.py``; reference
examples/rtl_data_stream.rs).

The transport is stdin/stdout: RequestData control packets arrive on stdin,
Data packets carrying the downsampled RTL-style u8 IQ stream leave on
stdout.  With ``--tcp PORT`` many clients connect at once, each with its
own position and credit window.  The source is a capture file; with
``--repeat`` the file loops forever, matching a live source.  The
downsampling runs on ``--device`` (default ``cuda``; ``--device cpu``
without a card).

Usage:
    python -m rustradio_tpu_torch.apps.rtl_data_stream -r capture.u8 \
        --sample_rate 250k --downsample_rate 50k < control.bin > data.bin
    python -m rustradio_tpu_torch.apps.rtl_data_stream -r capture.u8 --tcp 7000
"""

from __future__ import annotations

import argparse
import asyncio
import os
import queue
import sys
import threading

import numpy as np
import torch

from .. import ops
from .. import taps as tapgen
from ..dtypes import parse_frequency
from ..io import data_stream, rawfile
from ..ops.fft import as_stream
from . import add_device_arg, parse_device


def downsample_u8(raw_u8, sample_rate: float, downsample_rate: float,
                  device=None) -> bytes:
    """RTL u8 IQ -> low-pass -> resample -> re-encode as RTL u8 IQ, the
    reference chain RtlSdrDecode -> FftFilter -> RationalResampler ->
    RtlSdrEncode (examples/rtl_data_stream.rs graph body).  The u8 bytes go
    to the card (or ``device``) once; the low-pass
    ``low_pass_complex(sr, dr/2, dr/10)`` runs as kernel A on both planes
    (``ops.filter_complex``).  ``raw_u8`` is a uint8 tensor (run on its
    device) or a numpy array with ``device=``."""
    x = as_stream(raw_u8, device, "downsample_u8", torch.uint8)
    sr, dr = float(sample_rate), float(downsample_rate)
    lp = tapgen.low_pass_complex(sr, dr / 2.0, dr / 10.0, "hamming")
    y = ops.filter_complex(rawfile.rtlsdr_decode(x), lp)
    y = ops.rational_resampler(y, int(dr), int(sr))
    return rawfile.rtlsdr_encode(y).cpu().numpy().tobytes()


def control_reader(stdin, requests: "queue.Queue"):
    """Background thread: parse RequestData packets from stdin; None marks
    end of control input (reference spawn_control_reader,
    examples/rtl_data_stream.rs:138-170)."""
    parser = data_stream.BytesReader()
    try:
        while True:
            chunk = stdin.read(4096)
            if not chunk:
                break
            for ev in parser.feed(chunk):
                if ev[0] == "request_data":
                    requests.put((ev[1], ev[2]))
                elif ev[0] != "version":
                    raise data_stream.ProtocolError(f"unexpected input: {ev[0]}")
    except (data_stream.ProtocolError, OSError) as e:
        print(f"protocol input error: {e}", file=sys.stderr)
    finally:
        requests.put(None)


def serve_stdio(payload: bytes, stdin, stdout, stream_id: str = "rtl-sdr",
                packet_bytes: int = 16_384, repeat: bool = False) -> None:
    """The stdin/stdout protocol loop: Version first, then Data packets of
    at most ``packet_bytes`` within the credit that RequestData packets on
    ``stdin`` grant (each replaces the last); ends when the payload is sent
    (unless ``repeat``) or the control input has closed and its credit is
    spent."""
    writer = data_stream.SyncWriter(stdout.write)
    requests: "queue.Queue" = queue.Queue()
    threading.Thread(target=control_reader, args=(stdin, requests),
                     daemon=True).start()
    pos = 0
    input_closed = False
    exhausted = False
    while not exhausted:
        win = writer.windows.get(stream_id, 0)
        if win <= 0:
            # Idle: wait for a new grant; on control EOF drain and exit.
            if input_closed:
                break
            req = requests.get()
        else:
            # Between sends just drain the queue non-blockingly so a
            # replacing RequestData (including window=0: "stop") applies
            # immediately — the reference updates the window between every
            # send (examples/rtl_data_stream.rs:108).
            try:
                req = requests.get_nowait()
            except queue.Empty:
                req = ()
        if req is None:
            input_closed = True
            continue
        if req:
            sid, window = req
            if sid == stream_id:
                writer.grant(sid, window)
            continue
        if pos >= len(payload):
            if not repeat:
                exhausted = True
                continue
            pos = 0
        sent = writer.send(stream_id, payload[pos : pos + packet_bytes])
        pos += sent
        if sent == 0:
            break
    stdout.flush()


def payload_reader(payload: bytes, repeat: bool):
    """``payload_fn(pos, n)`` of a ``DataStreamServer``: the payload's bytes
    from ``pos``, looping when ``repeat``, b"" past the end otherwise."""
    def payload_at(pos: int, n: int) -> bytes:
        if repeat:
            pos %= len(payload)
        elif pos >= len(payload):
            return b""
        return payload[pos : pos + n]
    return payload_at


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="RTL u8 IQ capture file")
    p.add_argument("-s", "--sample_rate", type=parse_frequency, default=250_000.0)
    p.add_argument("-d", "--downsample_rate", type=parse_frequency, default=50_000.0)
    p.add_argument("--stream-id", default="rtl-sdr")
    p.add_argument("--packet-bytes", type=int, default=16_384)
    p.add_argument("--repeat", action="store_true", help="loop the capture")
    p.add_argument("--tcp", type=int, metavar="PORT",
                   help="serve many concurrent clients over TCP instead of "
                        "stdin/stdout (nonblocking asyncio server)")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    raw = np.fromfile(opt.read, np.uint8)
    payload = downsample_u8(raw, float(opt.sample_rate),
                            float(opt.downsample_rate), device=device)

    if opt.tcp is not None:
        async def amain():
            srv = data_stream.DataStreamServer(
                payload_reader(payload, opt.repeat), opt.stream_id,
                opt.packet_bytes)
            host, port = await srv.serve("0.0.0.0", opt.tcp)
            print(f"serving DATA_STREAM on {host}:{port}", file=sys.stderr)
            await asyncio.Event().wait()  # until interrupted

        try:
            asyncio.run(amain())
        except KeyboardInterrupt:
            pass
        return 0

    stdin = os.fdopen(sys.stdin.fileno(), "rb", buffering=0, closefd=False)
    stdout = os.fdopen(sys.stdout.fileno(), "wb", buffering=0, closefd=False)
    serve_stdio(payload, stdin, stdout, opt.stream_id, opt.packet_bytes,
                opt.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
