"""SDR source blocks with a live control plane and telemetry tags (port of
``rustradio_tpu/hw/source.py``).

* :class:`SdrControl` — thread-safe command handle
  (reference src/rtlsdr_source.rs:28-57 RtlSdrControl).
* :class:`SdrSource` — complex baseband source over any
  :class:`~rustradio_tpu_torch.hw.driver.SdrDriver`; emits `time_ns` + sensor
  tags on an interval and applies queued commands between reads
  (reference src/soapysdr_source.rs:378-416 work loop + rtlsdr_source.rs
  :124-148 command drain).
* :class:`RtlSdrSource` — u8 IQ byte-stream flavor
  (reference src/rtlsdr_source.rs emits the raw u8 stream, decoded
  downstream by ``io.rtlsdr_decode``).

A source reads its driver on the host and emits each read as a tensor on
the device the runner names.  ``emit_tags`` returns the tags of the last
``emit``: the Graph runners call ``emit`` and then ``emit_tags`` for each
chunk, so the tags land on the chunk they belong to.
"""

from __future__ import annotations

import queue

import numpy as np
import torch

from ..blocks.base import SourceBlock
from ..io import rawfile
from ..streams import Tag


class SdrControl:
    """Live command channel: retune/gain/rate without rebuilding the graph.

    Thread-safe; commands are applied by the source between chunk reads,
    exactly like the reference's reader thread drains its mpsc channel
    between blocking reads (src/rtlsdr_source.rs:124-148).
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def set_frequency(self, hz: float) -> None:
        self._q.put(("frequency", float(hz)))

    def set_gain(self, gain: float) -> None:
        self._q.put(("gain", float(gain)))

    def set_sample_rate(self, sps: float) -> None:
        self._q.put(("sample_rate", float(sps)))


class RtlSdrControl(SdrControl):
    """RTL-SDR-flavored names (reference src/rtlsdr_source.rs:40-56)."""

    def set_center_freq_hz(self, hz: int) -> None:
        self.set_frequency(float(hz))

    def set_gain_db(self, gain_db: int) -> None:
        # reference maps dB to the driver's tenth-dB API; the driver
        # interface is normalized 0-1, so map 0-50 dB onto it
        self.set_gain(min(max(gain_db / 50.0, 0.0), 1.0))


class SdrSource(SourceBlock):
    """Complex baseband source over an SdrDriver.

    Tags (all at position 0 of the chunk where they occur):

    * at stream start: ``<prefix>::frequency``, ``sample_rate``,
      ``input_gain``, ``driver``, ``hardware``, ``channel``, plus any
      builder extras — the reference's build-time tag set
      (src/soapysdr_source.rs:132-167).
    * every ``time_tag_interval`` seconds of *stream time*:
      ``<prefix>::time_ns`` and ``<prefix>::sensor_<name>`` for each
      allowlisted sensor (src/soapysdr_source.rs:395-412; the reference
      uses wall-clock — stream time is the deterministic equivalent).
    * after a command applies: the changed parameter re-tagged.
    * after a driver overflow: ``<prefix>::overflow`` with the count.
    """

    graph_capturable = False  # a source: reads the driver
    domain = "host"

    def __init__(
        self,
        driver,
        n: int | None = None,
        time_tag_interval: float = 1.0,
        prefix: str = "SdrSource",
        channel: int = 0,
        allowed_sensors: set[str] | None = frozenset(
            {"gps_time", "gps_locked", "ref_locked", "lo_locked"}
        ),
        extra_tags: list[Tag] | None = None,
    ):
        self.driver = driver
        self.n = n
        self.interval = float(time_tag_interval)
        self.prefix = prefix
        self.channel = channel
        self.allowed_sensors = allowed_sensors
        self._ctl = self._make_control()
        self._tags: list[Tag] = []
        self._started = False
        self._elapsed = 0.0
        self._next_time_tag = 0.0
        self._eof = False
        self._extra = list(extra_tags or [])

    def _make_control(self) -> SdrControl:
        return SdrControl()

    def control(self) -> SdrControl:
        """Handle for retuning while the graph runs
        (reference src/rtlsdr_source.rs:172-175)."""
        return self._ctl

    # ---- tag helpers ----
    def _t(self, key: str, val) -> Tag:
        return Tag(0, f"{self.prefix}::{key}", val)

    def _start_tags(self) -> list[Tag]:
        info = self.driver.info()
        return [
            self._t("channel", self.channel),
            self._t("input_gain", float(self.driver.gain)),
            self._t("frequency", float(self.driver.frequency)),
            self._t("sample_rate", float(self.driver.sample_rate)),
            self._t("driver", str(info.get("driver", ""))),
            self._t("hardware", str(info.get("hardware", ""))),
        ] + self._extra

    def _telemetry_tags(self) -> list[Tag]:
        out = [self._t("time_ns", self.driver.time_ns())]
        for name, val in self.driver.sensors().items():
            if self.allowed_sensors is None or name in self.allowed_sensors:
                out.append(self._t(f"sensor_{name}", val))
        return out

    def _drain_commands(self) -> list[Tag]:
        out = []
        while True:
            try:
                cmd, val = self._ctl._q.get_nowait()
            except queue.Empty:
                return out
            getattr(self.driver, f"set_{cmd}")(val)
            key = {"gain": "input_gain"}.get(cmd, cmd)
            out.append(self._t(key, val))

    # ---- SourceBlock protocol ----
    def total_len(self):
        return self.n

    def exhausted(self) -> bool:
        return self._eof

    def _read(self, n: int) -> np.ndarray:
        """Read n baseband samples; override to change the wire format."""
        return self.driver.read(n)

    def emit(self, offset, n, device):
        """The next ``n`` samples read from the driver, as a tensor on
        ``device`` (fewer at the end of a finite stream)."""
        tags: list[Tag] = []
        if not self._started:
            self._started = True
            tags += self._start_tags()
        tags += self._drain_commands()
        if self._elapsed >= self._next_time_tag:
            tags += self._telemetry_tags()
            self._next_time_tag = self._elapsed + self.interval
        data = self._read(n)
        ov = self.driver.take_overflows()
        if ov:
            tags.append(self._t("overflow", ov))
        if len(data) < n:
            self._eof = True
        self._elapsed += self._samples_of(len(data)) / float(self.driver.sample_rate)
        self._tags = tags
        return torch.from_numpy(np.ascontiguousarray(data)).to(device)

    def _samples_of(self, emitted: int) -> float:
        return float(emitted)

    def emit_tags(self, offset, n):
        return list(self._tags)


class RtlSdrSource(SdrSource):
    """u8 offset-127 IQ byte stream over an SdrDriver (reference
    src/rtlsdr_source.rs emits raw RTL bytes; pair with RtlSdrDecode).

    ``n`` and chunk sizes are in BYTES (2 bytes per complex sample).
    """

    graph_capturable = False  # a source: reads the driver

    def __init__(self, driver, n: int | None = None, **kw):
        kw.setdefault("prefix", "RtlSdrSource")
        super().__init__(driver, n=n, **kw)

    def _make_control(self) -> RtlSdrControl:
        return RtlSdrControl()

    def _read(self, n: int) -> np.ndarray:
        iq = self.driver.read(n // 2)
        return rawfile.rtlsdr_encode(iq)

    def _samples_of(self, emitted: int) -> float:
        return emitted / 2.0
