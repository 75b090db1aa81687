"""Browser UI: live spectrum + waterfall dashboard served over HTTP (port
of ``rustradio_tpu/ui``).

The counterpart of the reference's browser UI crate
(rustradio-ui/src/lib.rs:44-62, doc/ui.md:1-44) and the rtl_fm terminal
waterfall (examples/rtl_fm.rs:81-120): the card computes batched FFT
frames (cuFFT), the host serves them to a canvas dashboard.
"""

from .server import SpectrumFeed, UiServer

__all__ = ["SpectrumFeed", "UiServer"]
