"""Host-side I/O (port of ``rustradio_tpu/io``): raw sample files, the
rtl-sdr u8 wire format, Sun .au audio, SigMF recordings, and the
DATA_STREAM protocol over byte streams, TCP and websockets."""

from .au import au_decode, au_encode, au_read
from . import data_stream, sigmf, websocket
from .rawfile import read_samples, rtlsdr_decode, rtlsdr_encode, write_samples

__all__ = ["au_decode", "au_encode", "au_read", "data_stream", "read_samples",
           "rtlsdr_decode", "rtlsdr_encode", "sigmf", "websocket",
           "write_samples"]
