"""Device time of the wideband receiver's clock recovery a pass: the
kernels whose name holds ``symbol_sync`` (kernel E, one launch for the
whole bank), summed over the traced window and divided by the passes.
The reading of ``symbol_sync_ms_per_pass``, under the wideband cell's own
name."""

from .symbol_sync_ms_per_pass import read  # noqa: F401
