"""CLI applications (port of ``rustradio_tpu/apps``): the wideband channel
scanner, the narrow-band FM receiver ``rtl_fm``, the AM receiver
``am_decode``, the 9600 bd receivers ``ax25_9600_rx`` and
``ax25_9600_wpcr``, the 1200 bd burst receiver ``ax25_1200_wpcr``, the
G3RUH KISS modem ``g3ruh``, ``burst_saver``, the radio-facing receivers,
and the generators ``tone``, ``fm_tx``, ``morse_beacon``, ``pw_tone`` and
the spectrum viewer ``spectrum``."""

from __future__ import annotations

import argparse

import torch

from .._device import target_device


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device for the capture (default cuda)")


def parse_device(p: argparse.ArgumentParser, name: str) -> torch.device:
    """``--device`` as a torch device; the card's absence is a usage error
    that names ``--device cpu`` (nothing moves to the CPU by itself)."""
    try:
        return target_device(name, "--device")
    except RuntimeError:
        p.error(f"--device {name}: no CUDA device here; pass --device cpu")
