"""The generators: a traffic file's parameters and the seed -> the inputs
of a run, made on the run's device with a ``torch.Generator`` seeded
from ``--seed`` in a few large calls.

A traffic file names its signal with ``"generator"``, and
``generators/<generator>.py`` makes it: a module with ``make(traffic,
config, seed, device)``, which returns a dict of tensors and host values
(``truth`` holds what the transmitter sent, where the check compares the
receiver with it).  So a new kind of signal is a new file, found by its
name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness import module

SEED_MASK = (1 << 64) - 1


def rng(seed: int) -> np.random.Generator:
    """The host-side generator of a seed (any whole number)."""
    return np.random.default_rng(seed & SEED_MASK)


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & SEED_MASK)
    return g


def make_inputs(traffic: dict, config: dict, seed: int, device) -> dict:
    name = traffic.get("generator")
    try:
        gen = module("generators", name)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"unknown generator {name!r}: no "
                         f"radiobench/generators/{name}.py") from None
    return gen.make(traffic, config, seed, device)
