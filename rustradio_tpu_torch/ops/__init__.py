"""Stream ops of the FM receive chain on torch tensors.

Ops run on their inputs' device.  The kernel wrappers (``kernels``) launch
hand-written CUDA kernels for CUDA tensors and run their plain PyTorch
versions for CPU tensors.
"""

from .demod import fast_atan2, fast_fm, quadrature_demod
from .fir import fir_filter, fir_filter_full
from .kernels import (
    LAUNCHES,
    fir_decimate,
    fm_chain,
    fm_chain_window,
    fm_plane_pack,
)

__all__ = [
    "LAUNCHES",
    "fast_atan2",
    "fast_fm",
    "fir_decimate",
    "fir_filter",
    "fir_filter_full",
    "fm_chain",
    "fm_chain_window",
    "fm_plane_pack",
    "quadrature_demod",
]
