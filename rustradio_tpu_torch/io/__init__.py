"""Host-side I/O (port of ``rustradio_tpu/io``): raw sample files, the
rtl-sdr u8 wire format, Sun .au audio and SigMF recordings."""

from .au import au_decode, au_encode, au_read
from . import sigmf
from .rawfile import read_samples, rtlsdr_decode, rtlsdr_encode, write_samples

__all__ = ["au_decode", "au_encode", "au_read", "read_samples",
           "rtlsdr_decode", "rtlsdr_encode", "sigmf", "write_samples"]
