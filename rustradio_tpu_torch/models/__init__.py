"""Receive chains built from the ops."""

from .ax25 import (
    Ax25Packet,
    ax25_1200_rx,
    ax25_1200_rx_iq,
    bell202_demod,
    bell202_tone_demod,
    iq_front_end,
    parse_ax25,
)
from .fm import fm_demod_chain, fm_demod_chain_planar, fm_pack_planes
from .multichannel import ChannelDecode, decode_band_ax25, recover_symbols_batch

__all__ = [
    "Ax25Packet",
    "ChannelDecode",
    "ax25_1200_rx",
    "ax25_1200_rx_iq",
    "bell202_demod",
    "bell202_tone_demod",
    "decode_band_ax25",
    "fm_demod_chain",
    "fm_demod_chain_planar",
    "fm_pack_planes",
    "iq_front_end",
    "parse_ax25",
    "recover_symbols_batch",
]
