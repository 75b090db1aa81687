"""Stream ops on torch tensors.

Ops run on their inputs' device.  The kernel wrappers (``kernels``) launch
hand-written CUDA kernels for CUDA tensors and run their plain PyTorch
versions for CPU tensors.  The host-side ops (``hdlc``, ``il2p``,
``symbol_sync``) run on numpy arrays and take tensors from any device; the
device forms of the clock recovery (``symbol_sync``,
``symbol_sync_events``) run on their input's device through kernels D and
E, and the recurrences ``cma_equalize`` and ``iir_filter`` through kernels
F and G.  As in the JAX package, the
functions ``symbol_sync`` and ``wpcr`` shadow their modules here: import
those modules by their full path.
"""

from . import kernels
from .burst import burst_tagger, pdu_average, stream_to_pdu
from .cma import cma_equalize
from .correlate import correlate_access_code
from .delay import delay, head, skip
from .demod import fast_atan2, fast_fm, quadrature_demod
from .elementwise import (
    add,
    add_const,
    binary_slicer,
    complex_to_float,
    complex_to_mag2,
    complex_to_real,
    float_to_complex,
    multiply,
    multiply_const,
    xor,
    xor_const,
)
from .fft_filter import (
    fft_filter,
    fft_filter_decimate,
    fft_filter_float,
    filter_complex,
    filter_float,
)
from .fft import fft_pdu, fft_stream
from .fir import fir_filter, fir_filter_full, fir_filter_translating
from .hdlc import calc_crc, fcs_add, hdlc_bit_hunt, hdlc_deframe, hdlc_frame
from .hilbert import hilbert_transform
from .iir import iir_filter, single_pole_iir
from .kernels import (
    LAUNCHES,
    fir_decimate,
    fm_chain,
    fm_chain_window,
    fm_plane_pack,
)
from .nrzi import nrzi_decode, nrzi_encode
from .resampler import rational_resampler, resampler_indices
from .scramble import descramble, scramble
from .signal import signal_source_c, signal_source_f
from .symbol_sync import (
    compact,
    recover_symbols,
    symbol_sync,
    symbol_sync_events,
    zero_crossing_sync,
)
from .vco import vco
from .wpcr import midpoint, midpoint_batch, prewarm_buckets, wpcr, wpcr_batch


def quad_demod_fast(x, gain: float = 1.0):
    """Quadrature demod with the polynomial atan2, n - 1 f32 outputs
    (counterpart of the JAX package's ``pallas_quad_demod``): kernel C on
    a CUDA tensor, its plain version on a CPU tensor.  ``x`` is a 1-D
    contiguous complex64 tensor.  Calls ``kernels.quad_demod_fast`` through
    the module, so a patched kernel attribute reaches this entry point."""
    return kernels.quad_demod_fast(x, gain)


__all__ = [
    "LAUNCHES",
    "add",
    "add_const",
    "binary_slicer",
    "burst_tagger",
    "calc_crc",
    "cma_equalize",
    "compact",
    "complex_to_float",
    "complex_to_mag2",
    "complex_to_real",
    "correlate_access_code",
    "delay",
    "descramble",
    "fast_atan2",
    "fast_fm",
    "fcs_add",
    "fft_filter",
    "fft_filter_decimate",
    "fft_filter_float",
    "fft_pdu",
    "fft_stream",
    "filter_complex",
    "filter_float",
    "fir_decimate",
    "fir_filter",
    "fir_filter_full",
    "fir_filter_translating",
    "float_to_complex",
    "fm_chain",
    "fm_chain_window",
    "fm_plane_pack",
    "hdlc_bit_hunt",
    "hdlc_deframe",
    "hdlc_frame",
    "head",
    "hilbert_transform",
    "iir_filter",
    "midpoint",
    "midpoint_batch",
    "multiply",
    "multiply_const",
    "nrzi_decode",
    "nrzi_encode",
    "pdu_average",
    "prewarm_buckets",
    "quad_demod_fast",
    "quadrature_demod",
    "rational_resampler",
    "recover_symbols",
    "resampler_indices",
    "scramble",
    "signal_source_c",
    "signal_source_f",
    "single_pole_iir",
    "skip",
    "stream_to_pdu",
    "symbol_sync",
    "symbol_sync_events",
    "vco",
    "wpcr",
    "wpcr_batch",
    "xor",
    "xor_const",
    "zero_crossing_sync",
]
