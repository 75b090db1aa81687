"""PipeWire audio source/sink (port of ``rustradio_tpu/hw/pipewire.py``;
reference src/pipewire_source.rs / src/pipewire_sink.rs).

PipeWire is driven through the ``pw-cat`` client binary when present
(record/playback of raw f32 mono).  Without it, pass ``command=`` to
substitute any byte-producing/consuming process (tests use this), or use
AudioSink's other backends.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch

from ..blocks.base import Block, SourceBlock
from .sink import _host


def _pw_cat_available() -> bool:
    return shutil.which("pw-cat") is not None


class PipewireSource(SourceBlock):
    """f32 mono audio capture via a subprocess pipe."""

    graph_capturable = False  # a source: reads the recorder
    domain = "host"

    def __init__(self, sample_rate: int, n: int | None = None,
                 command: list[str] | None = None):
        self.sample_rate = int(sample_rate)
        self.n = n
        if command is None:
            if not _pw_cat_available():
                raise RuntimeError(
                    "pw-cat not found; pass command=[...] or use a file source"
                )
            command = ["pw-cat", "--record", "-", "--format", "f32",
                       "--rate", str(sample_rate), "--channels", "1"]
        self._proc = subprocess.Popen(command, stdout=subprocess.PIPE)
        self._eof = False

    def total_len(self):
        return self.n

    def exhausted(self) -> bool:
        return self._eof

    def emit(self, offset, n, device):
        want = 4 * n
        buf = b""
        while len(buf) < want:
            chunk = self._proc.stdout.read(want - len(buf))
            if not chunk:
                self._eof = True
                break
            buf += chunk
        k = len(buf) // 4
        pcm = np.frombuffer(buf[: 4 * k], "<f4").astype(np.float32)
        return torch.from_numpy(pcm).to(device)

    def finish(self):
        # graph end-of-run hook: stop the recorder subprocess
        self._proc.terminate()
        self._proc.wait(timeout=10)

    close = finish


class PipewireSink(Block):
    """f32 mono audio playback via a subprocess pipe."""

    graph_capturable = False  # host: writes to the player
    n_out = 0
    domain = "host"

    def __init__(self, sample_rate: int, command: list[str] | None = None,
                 writer=None):
        self.sample_rate = int(sample_rate)
        self._writer = writer
        self._proc = None
        if writer is None:
            if command is None:
                if not _pw_cat_available():
                    raise RuntimeError(
                        "pw-cat not found; pass command=[...] or writer="
                    )
                command = ["pw-cat", "--playback", "-", "--format", "f32",
                           "--rate", str(sample_rate), "--channels", "1"]
            self._proc = subprocess.Popen(command, stdin=subprocess.PIPE)
            self._writer = self._proc.stdin

    def apply(self, x):
        self._writer.write(_host(x, np.float32).astype("<f4").tobytes())
        self._writer.flush()
        return ()

    def finish(self):
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)
