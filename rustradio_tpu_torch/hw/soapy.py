"""SoapySDR-compatible source/sink surface (copy of
``rustradio_tpu/hw/soapy.py``).

Mirrors the reference's builder API (src/soapysdr_source.rs:80-167
SoapySdrSourceBuilder: channel/igain/antenna/gps_coordinates/build) over
the driver interface.  With a real SoapySDR python module present a
:class:`SoapyDriver` adapter binds to hardware; without one, pass any
:class:`~rustradio_tpu_torch.hw.driver.SdrDriver` (e.g. SimDriver) as the
device.
"""

from __future__ import annotations

from .driver import SdrDriver
from .sink import SdrSink
from .source import SdrSource
from ..streams import Tag

# reference src/soapysdr_source.rs:20-33
ALLOWED_SENSORS = frozenset({"gps_time", "gps_locked", "ref_locked", "lo_locked"})
POSITION_SENSORS = frozenset({"gps_gpgga", "gps_gprmc", "gps_servo"})


class SoapyDriver(SdrDriver):
    """Adapter over the real SoapySDR python bindings (if installed)."""

    def __init__(self, device_args: str, frequency: float, sample_rate: float,
                 gain: float = 0.5, channel: int = 0):
        try:
            import SoapySDR  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "SoapySDR python bindings not available; pass a SimDriver "
                "(rustradio_tpu_torch.hw.SimDriver) as the device instead"
            ) from e
        import SoapySDR
        from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_RX

        super().__init__(frequency, sample_rate, gain)
        self._sdr = SoapySDR.Device(device_args)
        self._channel = channel
        self._sdr.setFrequency(SOAPY_SDR_RX, channel, frequency)
        self._sdr.setSampleRate(SOAPY_SDR_RX, channel, sample_rate)
        gr = self._sdr.getGainRange(SOAPY_SDR_RX, channel)
        self._sdr.setGain(
            SOAPY_SDR_RX, channel, gr.minimum() + gain * (gr.maximum() - gr.minimum())
        )
        self._stream = self._sdr.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32, [channel])
        self._sdr.activateStream(self._stream)

    def info(self):
        return {
            "driver": self._sdr.getDriverKey(),
            "hardware": self._sdr.getHardwareKey(),
        }

    def sensors(self):
        return {s: self._sdr.readSensor(s) for s in self._sdr.listSensors()}

    def time_ns(self):
        return int(self._sdr.getHardwareTime())

    # live command channel -> hardware (the SdrSource drains its queue
    # into these between reads)
    def set_frequency(self, hz):
        from SoapySDR import SOAPY_SDR_RX

        super().set_frequency(hz)
        self._sdr.setFrequency(SOAPY_SDR_RX, self._channel, float(hz))

    def set_sample_rate(self, sps):
        from SoapySDR import SOAPY_SDR_RX

        super().set_sample_rate(sps)
        self._sdr.setSampleRate(SOAPY_SDR_RX, self._channel, float(sps))

    def set_gain(self, gain):
        from SoapySDR import SOAPY_SDR_RX

        super().set_gain(gain)
        gr = self._sdr.getGainRange(SOAPY_SDR_RX, self._channel)
        self._sdr.setGain(
            SOAPY_SDR_RX, self._channel,
            gr.minimum() + float(gain) * (gr.maximum() - gr.minimum()),
        )

    def take_overflows(self):
        n, self._overflows = self._overflows, 0
        return n

    _overflows = 0

    def read(self, n):
        import numpy as np
        from SoapySDR import SOAPY_SDR_OVERFLOW, SOAPY_SDR_TIMEOUT

        out = np.empty(n, np.complex64)
        got = 0
        empty_reads = 0
        while got < n:
            sr = self._sdr.readStream(self._stream, [out[got:]], n - got)
            if sr.ret == SOAPY_SDR_TIMEOUT or sr.ret == 0:
                # transient — but a dead/unplugged device often times out
                # forever, so bound the wait (~readStream timeouts each)
                empty_reads += 1
                if empty_reads > self.max_empty_reads:
                    break
                continue
            if sr.ret == SOAPY_SDR_OVERFLOW:
                self._overflows += 1
                continue
            if sr.ret < 0:
                break  # fatal stream error -> end of stream
            empty_reads = 0
            got += sr.ret
        return out[:got]

    #: consecutive empty/timeout reads before the stream is declared dead
    max_empty_reads = 100


class SoapySdrSourceBuilder:
    """Builder parity with the reference (src/soapysdr_source.rs:80-167)."""

    def __init__(self, dev, freq: float, samp_rate: float):
        self._dev = dev
        self._freq, self._rate = float(freq), float(samp_rate)
        self._channel = 0
        self._igain = 0.5
        self._antenna: str | None = None
        self._gps = False

    def channel(self, channel: int):
        self._channel = channel
        return self

    def igain(self, igain: float):
        self._igain = igain
        return self

    def antenna(self, a: str):
        self._antenna = a
        return self

    def gps_coordinates(self, v: bool):
        self._gps = v
        return self

    def build(self) -> SdrSource:
        dev = self._dev
        dev.set_frequency(self._freq)
        dev.set_sample_rate(self._rate)
        dev.set_gain(self._igain)
        allowed = set(ALLOWED_SENSORS)
        if self._gps:
            allowed |= POSITION_SENSORS
        extra = []
        if self._antenna is not None:
            extra.append(Tag(0, "SoapySdrSource::antenna", self._antenna))
        return SdrSource(
            dev,
            prefix="SoapySdrSource",
            channel=self._channel,
            allowed_sensors=frozenset(allowed),
            extra_tags=extra,
        )


def SoapySdrSource(dev, freq: float, samp_rate: float) -> SoapySdrSourceBuilder:
    """`SoapySdrSource(dev, f, r).igain(..).build()` like the reference's
    `SoapySdrSource::builder(...)`."""
    return SoapySdrSourceBuilder(dev, freq, samp_rate)


class SoapySdrSink(SdrSink):
    """TX counterpart (reference src/soapysdr_sink.rs:19)."""

    graph_capturable = False  # host: writes to the driver

    def __init__(self, dev, freq: float, samp_rate: float, ogain: float = 0.5):
        dev.set_frequency(freq)
        dev.set_sample_rate(samp_rate)
        super().__init__(dev, ogain=ogain)
