"""Host-side I/O (port of ``rustradio_tpu/io``): raw sample files."""

from .rawfile import read_samples, write_samples

__all__ = ["read_samples", "write_samples"]
