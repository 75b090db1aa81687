"""SDR and audio sink blocks (port of ``rustradio_tpu/hw/sink.py``; both
take their stream to the host).

* :class:`SdrSink` — complex baseband TX over any SdrDriver
  (reference src/soapysdr_sink.rs:19; its work loop writes the stream to
  the device, :150-210).
* :class:`AudioSink` — f32 audio playback (reference src/audio_sink.rs
  via cpal).  No audio stack exists in this environment, so playback is
  a backend interface: a real backend (``sounddevice`` module or an
  ``aplay``/``pacat``/``pw-cat`` binary) is used when present; otherwise
  ``file``/``null`` backends keep the chain runnable and testable.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import torch

from ..blocks.base import Block


def _host(x, dtype) -> np.ndarray:
    """A stream chunk (a tensor on any device, or numpy) as host numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class SdrSink(Block):
    """Transmit a complex stream through an SdrDriver."""

    graph_capturable = False  # host: writes to the driver
    n_out = 0
    domain = "host"

    def __init__(self, driver, ogain: float | None = None):
        self.driver = driver
        if ogain is not None:
            driver.set_gain(ogain)

    def apply(self, x):
        self.driver.write(_host(x, np.complex64))
        return ()

    def finish(self):
        self.driver.close()


def _detect_audio_backend(sample_rate: int):
    """Pick the best available playback path, in preference order."""
    try:  # a real audio module, if the host has one
        import sounddevice  # noqa: F401

        return "sounddevice"
    except Exception:
        pass
    for exe in ("pw-cat", "pacat", "aplay"):
        if shutil.which(exe):
            return exe
    return "null"


class AudioSink(Block):
    """Play (or spool) a float32 audio stream.

    Backends:

    * ``"sounddevice"`` — direct playback via the sounddevice module.
    * ``"pw-cat"`` / ``"pacat"`` / ``"aplay"`` — pipe raw f32/s16 to the
      system player binary.
    * ``"file"`` — append raw f32 samples to ``path`` (test/offline use).
    * ``"null"`` — discard.
    * ``None`` — auto-detect (first available real backend, else null).
    """

    graph_capturable = False  # host: writes to the player
    n_out = 0
    domain = "host"

    def __init__(self, sample_rate: int, backend: str | None = None,
                 path: str | None = None, device: str | None = None):
        self.sample_rate = int(sample_rate)
        self.backend = backend or _detect_audio_backend(sample_rate)
        self.path = path
        self.device = device
        self._proc = None
        self._file = None
        self._stream = None
        if self.backend == "file":
            if not path:
                raise ValueError("file backend needs path=")
            self._file = open(path, "wb")

    def _ensure_started(self):
        if self.backend == "sounddevice" and self._stream is None:
            import sounddevice

            self._stream = sounddevice.OutputStream(
                samplerate=self.sample_rate, channels=1, dtype="float32",
                device=self.device,
            )
            self._stream.start()
        elif self.backend in ("pw-cat", "pacat", "aplay") and self._proc is None:
            cmd = {
                "pw-cat": ["pw-cat", "--playback", "-", "--format", "f32",
                           "--rate", str(self.sample_rate), "--channels", "1"],
                "pacat": ["pacat", "--format=float32le",
                          f"--rate={self.sample_rate}", "--channels=1"],
                "aplay": ["aplay", "-f", "FLOAT_LE", "-r",
                          str(self.sample_rate), "-c", "1", "-q"],
            }[self.backend]
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def apply(self, x):
        pcm = _host(x, np.float32)
        if self.backend == "null":
            return ()
        self._ensure_started()
        if self.backend == "sounddevice":
            self._stream.write(pcm.reshape(-1, 1))
        elif self._proc is not None:
            self._proc.stdin.write(pcm.astype("<f4").tobytes())
            self._proc.stdin.flush()
        elif self._file is not None:
            self._file.write(pcm.astype("<f4").tobytes())
            self._file.flush()
        return ()

    def finish(self):
        if self._file is not None:
            self._file.close()
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
