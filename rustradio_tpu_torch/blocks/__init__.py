"""Blocks of the port (port of ``rustradio_tpu/blocks``): the FM receive
chain, the AX.25 and IL2P receivers, the G3RUH modem and the burst
receivers."""

from .base import Block, SourceBlock
from .demod import FastFM, QuadratureDemod, Vco
from .digital import (
    CorrelateAccessCode,
    CorrelateAccessCodeTag,
    Descrambler,
    NrziDecode,
    NrziEncode,
    Scrambler,
    SymbolSync,
    ZeroCrossing,
)
from .elementwise import (
    AddConst,
    BinarySlicer,
    ComplexToMag2,
    FloatToComplex,
    MultiplyConst,
)
from .filters import (
    FftFilter,
    FftFilterFloat,
    FirFilter,
    Hilbert,
    IqBalance,
    SinglePoleIirFilter,
)
from .packets import (
    BurstTagger,
    FcsAdder,
    HdlcDeframer,
    HdlcFramer,
    Il2pDeframer,
    KissDecode,
    KissEncode,
    KissFrame,
    Midpointer,
    PduToStream,
    StreamToPdu,
    Wpcr,
)
from .rate import Delay, Head, RationalResampler, Skip
from .sinks import DeviceFoldSink, NullSink, PduVectorSink, VectorSink
from .sources import PackedIqRingSource, VectorSource

__all__ = [
    "AddConst",
    "BinarySlicer",
    "Block",
    "BurstTagger",
    "ComplexToMag2",
    "CorrelateAccessCode",
    "CorrelateAccessCodeTag",
    "Delay",
    "Descrambler",
    "DeviceFoldSink",
    "FastFM",
    "FcsAdder",
    "FftFilter",
    "FftFilterFloat",
    "FirFilter",
    "FloatToComplex",
    "HdlcDeframer",
    "HdlcFramer",
    "Head",
    "Hilbert",
    "Il2pDeframer",
    "IqBalance",
    "KissDecode",
    "KissEncode",
    "KissFrame",
    "Midpointer",
    "MultiplyConst",
    "NrziDecode",
    "NrziEncode",
    "NullSink",
    "PackedIqRingSource",
    "PduToStream",
    "PduVectorSink",
    "QuadratureDemod",
    "RationalResampler",
    "Scrambler",
    "SinglePoleIirFilter",
    "Skip",
    "SourceBlock",
    "StreamToPdu",
    "SymbolSync",
    "VectorSink",
    "VectorSource",
    "Vco",
    "Wpcr",
    "ZeroCrossing",
]
