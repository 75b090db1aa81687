"""Receive chains built from the ops."""

from .fm import fm_demod_chain, fm_demod_chain_planar, fm_pack_planes

__all__ = ["fm_demod_chain", "fm_demod_chain_planar", "fm_pack_planes"]
