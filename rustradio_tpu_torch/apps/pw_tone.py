"""Tone generator to the system audio output (port of
``rustradio_tpu/apps/pw_tone.py``; reference examples/pw_tone.rs,
pipewire playback): a ``SignalSourceFloat -> hw.AudioSink`` graph run by
``Graph.run_stream`` in quarter-second chunks, the tone made on
``--device`` (default ``cuda``; ``--device cpu`` without a card).

Plays through the best available audio backend (pw-cat / pacat / aplay /
sounddevice), or spools raw f32 with ``--backend file --out ...`` when
the host has no audio stack.

Usage:
    python -m rustradio_tpu_torch.apps.pw_tone --freq 8k --seconds 2
    python -m rustradio_tpu_torch.apps.pw_tone --backend file --out tone.f32
"""

from __future__ import annotations

import argparse
import sys

from .. import blocks
from ..dtypes import parse_frequency
from ..graph import Graph
from . import add_device_arg, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--freq", type=parse_frequency, default=8_000.0)
    p.add_argument("--volume", type=float, default=0.1)
    p.add_argument("--audio_rate", type=parse_frequency, default=48_000.0)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--backend", default=None,
                   help="audio backend (default: autodetect; 'file' needs --out)")
    p.add_argument("--out", help="output path for the file backend")
    add_device_arg(p)
    opt = p.parse_args(argv)
    device = parse_device(p, opt.device)

    from ..hw import AudioSink

    sink = AudioSink(int(opt.audio_rate), backend=opt.backend, path=opt.out)
    print(f"audio backend: {sink.backend}", file=sys.stderr)

    g = Graph()
    g.chain(
        blocks.SignalSourceFloat(
            float(opt.audio_rate), float(opt.freq), amplitude=opt.volume,
            n=int(opt.seconds * opt.audio_rate),
        ),
        sink,
    )
    # quarter-second chunks: live backends play as the graph streams
    g.run_stream(chunk_size=max(1, int(opt.audio_rate / 4)), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
