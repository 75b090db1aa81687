"""Published peaks of the cards the benchmark knows, matched on
``torch.cuda.get_device_name()`` (the first match wins, so the PCIe card
comes before the SXM one): device memory in bytes/s and float32
operations/s outside the tensor cores, from NVIDIA's data sheets.  A copy
of the program's ``utils.stats.CARDS``."""

from __future__ import annotations

CARDS = (
    ("H100 PCIe", 2000e9, 51.2e12),
    ("H100", 3350e9, 67e12),
)


def card_peaks(name: str) -> tuple[float, float] | None:
    """(bytes/s, f32 operations/s) of the card named ``name``; None for a
    card the table does not hold."""
    for key, bps, flops in CARDS:
        if key.lower() in name.lower():
            return bps, flops
    return None
