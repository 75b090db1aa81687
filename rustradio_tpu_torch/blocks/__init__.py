"""Blocks of the FM receive chain and the AX.25 receiver (port of
``rustradio_tpu/blocks``)."""

from .base import Block, SourceBlock
from .demod import QuadratureDemod
from .digital import NrziDecode, SymbolSync
from .elementwise import AddConst, BinarySlicer, FloatToComplex, MultiplyConst
from .filters import FftFilter, FftFilterFloat, FirFilter, Hilbert
from .packets import HdlcDeframer
from .sinks import DeviceFoldSink, NullSink, PduVectorSink, VectorSink
from .sources import PackedIqRingSource, VectorSource

__all__ = [
    "AddConst",
    "BinarySlicer",
    "Block",
    "DeviceFoldSink",
    "FftFilter",
    "FftFilterFloat",
    "FirFilter",
    "FloatToComplex",
    "HdlcDeframer",
    "Hilbert",
    "MultiplyConst",
    "NrziDecode",
    "NullSink",
    "PackedIqRingSource",
    "PduVectorSink",
    "QuadratureDemod",
    "SourceBlock",
    "SymbolSync",
    "VectorSink",
    "VectorSource",
]
