"""SDR driver interface + simulated loopback driver (numpy copy of
``rustradio_tpu/hw/driver.py``).

A driver owns the hardware session: it delivers baseband samples, honors
live parameter changes (the reference applies queued commands between
blocking reads, src/rtlsdr_source.rs:124-148), reports sensors and
hardware time (src/soapysdr_source.rs:12-48), and accepts TX samples
(src/soapysdr_sink.rs).  Blocks in hw.source/hw.sink are generic over
this interface.
"""

from __future__ import annotations

import numpy as np


class SdrDriver:
    """Abstract SDR driver.

    Frequencies are Hz, sample rates samples/second, gain is normalized
    0.0-1.0 (the reference's soapysdr igain convention,
    src/soapysdr_source.rs:113-118; dB-flavored APIs convert before
    calling in).
    """

    def __init__(self, frequency: float, sample_rate: float, gain: float = 0.5):
        self.frequency = float(frequency)
        self.sample_rate = float(sample_rate)
        self.gain = float(gain)

    # ---- identity / telemetry ----
    def info(self) -> dict:
        """Static identity strings (driver key, hardware key, ...)."""
        return {"driver": type(self).__name__, "hardware": "unknown"}

    def sensors(self) -> dict:
        """Current sensor readings, name -> typed value."""
        return {}

    def time_ns(self) -> int:
        """Hardware time of the next sample to be read, in ns."""
        raise NotImplementedError

    def take_overflows(self) -> int:
        """Overflow events since the last call (0 if none)."""
        return 0

    # ---- control plane ----
    def set_frequency(self, hz: float) -> None:
        self.frequency = float(hz)

    def set_sample_rate(self, sps: float) -> None:
        self.sample_rate = float(sps)

    def set_gain(self, gain: float) -> None:
        self.gain = float(gain)

    # ---- data plane ----
    def read(self, n: int) -> np.ndarray:
        """Blocking read of up to n complex64 baseband samples.

        A short or empty return means the stream ended (simulated drivers
        may be finite; live drivers never return empty).
        """
        raise NotImplementedError

    def write(self, samples: np.ndarray) -> None:
        """Transmit complex64 baseband samples."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SimDriver(SdrDriver):
    """Simulated RF front-end with loopback TX.

    RX: a synthetic spectrum of CW tones at *absolute* RF frequencies
    plus white noise.  Tones inside the current (frequency ± rate/2)
    window appear in baseband at their true offsets, so a retune command
    visibly moves the spectrum — the behavior scanner/receiver tests
    need from real hardware.

    TX: ``write`` records samples in ``tx_samples`` (inspect with
    ``tx_data()``), giving TX chains a loopback target.

    Deterministic: hardware time advances with the sample counter, not
    wall clock; sensors derive from stream time.
    """

    def __init__(
        self,
        frequency: float,
        sample_rate: float,
        gain: float = 0.5,
        tones: list[tuple[float, float]] | None = None,
        fm_tones: list[tuple[float, float, float, float]] | None = None,
        noise: float = 0.0,
        seed: int = 0,
        total_samples: int | None = None,
        epoch_ns: int = 1_700_000_000_000_000_000,
    ):
        super().__init__(frequency, sample_rate, gain)
        self.tones = list(tones or [])
        # (carrier_hz, amplitude, audio_hz, deviation_hz): an FM carrier
        # modulated by a single audio tone — receiver app demos
        self.fm_tones = list(fm_tones or [])
        self.noise = float(noise)
        self.seed = seed
        self.total_samples = total_samples
        self.epoch_ns = epoch_ns
        self._count = 0  # samples delivered
        self._elapsed = 0.0  # stream seconds (survives rate changes)
        self._overflows = 0
        self.tx_samples: list[np.ndarray] = []
        self.command_log: list[tuple[str, float]] = []

    # ---- identity / telemetry ----
    def info(self) -> dict:
        return {"driver": "sim", "hardware": "rustradio_tpu-loopback"}

    def sensors(self) -> dict:
        # the reference's sensor allowlist names (soapysdr_source.rs:20-25)
        return {
            "temp": 35.0 + 0.01 * self._elapsed,
            "ref_locked": True,
            "lo_locked": True,
            "gps_locked": False,
        }

    def time_ns(self) -> int:
        return self.epoch_ns + int(self._elapsed * 1e9)

    def inject_overflow(self, n: int = 1) -> None:
        self._overflows += n

    def take_overflows(self) -> int:
        n, self._overflows = self._overflows, 0
        return n

    # ---- control plane ----
    def set_frequency(self, hz: float) -> None:
        super().set_frequency(hz)
        self.command_log.append(("frequency", float(hz)))

    def set_sample_rate(self, sps: float) -> None:
        super().set_sample_rate(sps)
        self.command_log.append(("sample_rate", float(sps)))

    def set_gain(self, gain: float) -> None:
        super().set_gain(gain)
        self.command_log.append(("gain", float(gain)))

    # ---- data plane ----
    def read(self, n: int) -> np.ndarray:
        if self.total_samples is not None:
            n = min(n, self.total_samples - self._count)
            if n <= 0:
                return np.zeros(0, np.complex64)
        fs = self.sample_rate
        t = self._elapsed + np.arange(n) / fs
        out = np.zeros(n, np.complex64)
        for f, amp in self.tones:
            off = f - self.frequency
            if abs(off) <= fs / 2:
                out += (amp * np.exp(2j * np.pi * off * t)).astype(np.complex64)
        for f, amp, af, dev in self.fm_tones:
            off = f - self.frequency
            if abs(off) <= fs / 2:
                # phase(t) = 2π off t + (dev/af) sin(2π af t): continuous
                # in t across reads, so chunking leaves no phase seams
                ph = 2 * np.pi * off * t + (dev / af) * np.sin(2 * np.pi * af * t)
                out += (amp * np.exp(1j * ph)).astype(np.complex64)
        if self.noise > 0.0:
            rng = np.random.RandomState((self.seed + self._count) % (2**31))
            out += (
                self.noise
                * (rng.randn(n) + 1j * rng.randn(n))
                / np.sqrt(2.0)
            ).astype(np.complex64)
        self._count += n
        self._elapsed += n / fs
        return (out * np.complex64(self.gain)).astype(np.complex64)

    def write(self, samples: np.ndarray) -> None:
        self.tx_samples.append(np.asarray(samples, np.complex64).copy())

    def tx_data(self) -> np.ndarray:
        if not self.tx_samples:
            return np.zeros(0, np.complex64)
        return np.concatenate(self.tx_samples)


def parse_sim_tone(spec: str) -> tuple:
    """CLI tone spec -> SimDriver tone tuple.

    ``FREQ:AMP`` is a CW tone; ``FREQ:AMP:AUDIO:DEV`` an FM carrier
    (frequencies accept the reference's k/M/G suffixes,
    src/lib.rs parse_frequency).
    """
    from ..dtypes import parse_frequency

    parts = spec.split(":")
    if len(parts) == 2:
        return (parse_frequency(parts[0]), float(parts[1]))
    if len(parts) == 4:
        return (
            parse_frequency(parts[0]),
            float(parts[1]),
            parse_frequency(parts[2]),
            parse_frequency(parts[3]),
        )
    raise ValueError(f"tone spec {spec!r}: want FREQ:AMP or FREQ:AMP:AUDIO:DEV")


def sim_driver(frequency: float, sample_rate: float, specs, default) -> SimDriver:
    """The ``-r sim`` driver of the apps: a SimDriver at ``frequency`` and
    ``sample_rate`` (gain 1) carrying the tones of the ``--sim_tone``
    specs ``specs`` (:func:`parse_sim_tone`), or the tone tuples
    ``default`` where none is given."""
    tones = [parse_sim_tone(s) for s in specs] or list(default)
    return SimDriver(
        frequency=float(frequency),
        sample_rate=float(sample_rate),
        gain=1.0,
        tones=[t for t in tones if len(t) == 2],
        fm_tones=[t for t in tones if len(t) == 4],
    )
