"""Channel-parallel processing (port of ``rustradio_tpu/parallel``): so
far the polyphase channelizer.  The mesh layer (``mesh``, ``halo``,
``sharded``, ``sharded_channelizer_fm``) is not ported yet."""

from .channelizer import channelizer_fm_bank, channelizer_taps, pfb_channelize

__all__ = ["channelizer_fm_bank", "channelizer_taps", "pfb_channelize"]
