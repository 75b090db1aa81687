"""SDR hardware abstraction layer (port of ``rustradio_tpu/hw``).

The reference has four live-hardware modules, feature-gated in its CI
(src/rtlsdr_source.rs, src/soapysdr_source.rs, src/soapysdr_sink.rs,
src/audio_sink.rs + pipewire source/sink).  No SDR hardware or driver
libraries exist in this environment, so the hardware surface here is a
*driver interface* (:mod:`rustradio_tpu_torch.hw.driver`) with a simulated
loopback implementation (:class:`SimDriver`) — which makes the live
command channel, the sensor/time-tag telemetry, and overflow handling
real, testable components instead of permanent exclusions.  A machine
with real hardware only needs a driver adapter (see hw/soapy.py).  The
``rtlsdr``, ``SoapySDR`` and ``sounddevice`` modules are imported only
when their adapter is built, so importing this package needs none of them.
Sources read on the host and emit tensors on the runner's device; sinks
take their stream to the host.
"""

from .driver import SdrDriver, SimDriver
from .rtl import RtlDriver
from .source import RtlSdrControl, RtlSdrSource, SdrControl, SdrSource
from .sink import AudioSink, SdrSink
from .soapy import SoapySdrSink, SoapySdrSource
from .pipewire import PipewireSink, PipewireSource

__all__ = [
    "AudioSink",
    "PipewireSink",
    "PipewireSource",
    "RtlSdrControl",
    "RtlDriver",
    "RtlSdrSource",
    "SdrControl",
    "SdrDriver",
    "SdrSink",
    "SdrSource",
    "SimDriver",
    "SoapySdrSink",
    "SoapySdrSource",
]
