"""Stream ops on torch tensors.

Ops run on their inputs' device.  The kernel wrappers (``kernels``) launch
hand-written CUDA kernels for CUDA tensors and run their plain PyTorch
versions for CPU tensors.  The host-side ops (``hdlc``, ``symbol_sync``)
run on numpy arrays and take tensors from any device; the device forms of
the clock recovery (``symbol_sync``, ``symbol_sync_events``) run on their
input's device through kernels D and E.
"""

from . import kernels
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
from .fir import fir_filter, fir_filter_full
from .hdlc import calc_crc, fcs_add, hdlc_deframe, hdlc_frame
from .hilbert import hilbert_transform
from .kernels import (
    LAUNCHES,
    fir_decimate,
    fm_chain,
    fm_chain_window,
    fm_plane_pack,
)
from .nrzi import nrzi_decode, nrzi_encode
from .resampler import rational_resampler, resampler_indices
from .symbol_sync import compact, recover_symbols, symbol_sync, symbol_sync_events


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
    "calc_crc",
    "compact",
    "complex_to_float",
    "complex_to_mag2",
    "complex_to_real",
    "fast_atan2",
    "fast_fm",
    "fcs_add",
    "fft_filter",
    "fft_filter_decimate",
    "fft_filter_float",
    "filter_complex",
    "filter_float",
    "fir_decimate",
    "fir_filter",
    "fir_filter_full",
    "float_to_complex",
    "fm_chain",
    "fm_chain_window",
    "fm_plane_pack",
    "hdlc_deframe",
    "hdlc_frame",
    "hilbert_transform",
    "multiply",
    "multiply_const",
    "nrzi_decode",
    "nrzi_encode",
    "quad_demod_fast",
    "quadrature_demod",
    "rational_resampler",
    "recover_symbols",
    "resampler_indices",
    "symbol_sync",
    "symbol_sync_events",
    "xor",
    "xor_const",
]
