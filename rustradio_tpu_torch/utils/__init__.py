"""Utilities (port of ``rustradio_tpu/utils``): checkpoint/resume of the
streaming runner."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
