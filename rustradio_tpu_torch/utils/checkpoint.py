"""Checkpoint / resume for streaming graphs (port of
``rustradio_tpu/utils/checkpoint.py``, in its format).

The streaming runner's whole condition is (stream offset, per-block
state), so a checkpoint is those states with tensors pulled to host numpy
plus the global sample offset.  Format, shared with the JAX package: a
pickle of ``{"states", "offset", "extra", "version": 1}`` whose leaves are
numpy arrays or host values (Python scalars, strings, lists, tags).  A
checkpoint either package wrote loads in the other; on load the leaves go
to the run's device through :func:`..convert.state_from_jax`.  The JAX
package's stream tags and PDUs in a checkpoint (StreamToPdu's open burst)
load as the port's own classes, so loading imports nothing of that
package.
"""

from __future__ import annotations

import pickle

import torch

from ..convert import state_from_jax
from ..streams import Pdu, Tag

_PORTED = {("rustradio_tpu.streams", "Tag"): Tag,
           ("rustradio_tpu.streams", "Pdu"): Pdu}


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's stream classes onto the port's."""

    def find_class(self, module, name):
        return _PORTED.get((module, name)) or super().find_class(module, name)


def _to_host(tree):
    """Tensors -> numpy (via the CPU); everything else as it is."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, states: dict, offset: int,
                    extra: dict | None = None) -> None:
    """Save per-block states + stream offset."""
    payload = {
        "states": {k: _to_host(v) for k, v in states.items()},
        "offset": int(offset),
        "extra": extra or {},
        "version": 1,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path: str, template_states: dict | None = None,
                    device="cuda"):
    """Restore ``(states, offset, extra)``, the states' arrays as tensors on
    ``device``.  ``template_states`` (the graph's ``init_state()``s) only
    checks that the checkpoint has a state for every block."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("version") != 1:
        raise ValueError(f"unknown checkpoint version in {path}")
    states = payload["states"]
    if template_states is not None:
        missing = set(template_states) - set(states)
        if missing:
            raise ValueError(
                f"checkpoint {path} lacks state for blocks {sorted(missing)}; "
                "graph structure changed?")
    return state_from_jax(states, device), payload["offset"], payload["extra"]
