"""The port's one rule for a device an entry point is asked to run on."""

from __future__ import annotations

import torch


def target_device(device, what: str) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    (nothing moves to the CPU by itself) and says how to ask for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'{what}(device="{device}"): no CUDA device here; pass '
            'device="cpu" to run on the kernels\' plain versions')
    return device
