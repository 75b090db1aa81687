"""Utilities (port of ``rustradio_tpu/utils``): checkpoint/resume of the
streaming runner, throughput and roofline accounting (``stats``), and
the spectrogram and its ASCII waterfall (``waterfall``)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .stats import RateMeter, roofline_report

__all__ = ["RateMeter", "load_checkpoint", "roofline_report", "save_checkpoint"]
