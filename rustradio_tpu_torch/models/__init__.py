"""Receive chains built from the ops."""

from .ax25 import (
    Ax25Packet,
    ax25_1200_rx,
    ax25_1200_rx_graph,
    ax25_1200_rx_iq,
    ax25_1200_wpcr_rx,
    ax25_9600_rx,
    ax25_9600_wpcr_rx,
    bell202_demod,
    bell202_tone_demod,
    g3ruh_modulate,
    il2p_1200_rx,
    iq_front_end,
    parse_ax25,
)
from .fm import (
    am_rx,
    fm_demod_chain,
    fm_demod_chain_planar,
    fm_pack_planes,
    wbfm_rx,
)
from .multichannel import ChannelDecode, decode_band_ax25, recover_symbols_batch

__all__ = [
    "Ax25Packet",
    "ChannelDecode",
    "am_rx",
    "ax25_1200_rx",
    "ax25_1200_rx_graph",
    "ax25_1200_rx_iq",
    "ax25_1200_wpcr_rx",
    "ax25_9600_rx",
    "ax25_9600_wpcr_rx",
    "bell202_demod",
    "bell202_tone_demod",
    "decode_band_ax25",
    "fm_demod_chain",
    "fm_demod_chain_planar",
    "fm_pack_planes",
    "g3ruh_modulate",
    "il2p_1200_rx",
    "iq_front_end",
    "parse_ax25",
    "recover_symbols_batch",
    "wbfm_rx",
]
