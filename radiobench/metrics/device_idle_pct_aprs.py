"""``device_idle_pct`` of the AX.25 cells, which moves their own rate
``msps_aprs``: the same reading, 100 * (1 - the union of the device's
kernel, copy and fill intervals over the traced window's span)."""

from .device_idle_pct import read  # noqa: F401
