"""Blocks of the FM receive chain (port of ``rustradio_tpu/blocks``)."""

from .base import Block, SourceBlock
from .demod import QuadratureDemod
from .elementwise import FloatToComplex
from .filters import FirFilter
from .sinks import DeviceFoldSink, NullSink, VectorSink
from .sources import PackedIqRingSource, VectorSource

__all__ = [
    "Block",
    "DeviceFoldSink",
    "FirFilter",
    "FloatToComplex",
    "NullSink",
    "PackedIqRingSource",
    "QuadratureDemod",
    "SourceBlock",
    "VectorSink",
    "VectorSource",
]
