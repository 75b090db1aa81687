"""Utilities (port of ``rustradio_tpu/utils``): checkpoint/resume of the
streaming runner, throughput and roofline accounting (``stats``), and
the spectrogram and its ASCII waterfall (``waterfall``)."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
