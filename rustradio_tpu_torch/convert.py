"""Carry the JAX package's data across into the port, as numpy arrays.

The port never imports jax; these take what the JAX package produced
after ``np.asarray`` — packed planes and streaming block states (a
checkpoint's leaves) — so a stream started in the JAX package goes on in
the port.  Like every entry point of the port they put their tensors on
the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import target_device
from .ops import kernels
from .streams import Tag


def packed_from_jax(plane_np, precision: str, device="cuda") -> torch.Tensor:
    """An ``fm_plane_pack`` output of the JAX package ((rows, deci*128),
    bfloat16 via ml_dtypes, int8 or float32) as the port's 1-D packed
    plane on ``device``: the same samples in the same order, a reshape plus
    a dtype view."""
    device = target_device(device, "packed_from_jax")
    a = np.ascontiguousarray(plane_np).reshape(-1)
    want = kernels.plane_dtype(precision)
    if want == torch.bfloat16:
        if a.dtype.name != "bfloat16":
            raise ValueError(f"precision {precision!r} needs a bfloat16 plane, "
                             f"got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
        if t.dtype != want:
            raise ValueError(f"precision {precision!r} needs a {want} plane, "
                             f"got {a.dtype}")
    return t.to(device)


def _is_tag(x) -> bool:
    """A stream tag of either package (the JAX package's ``Tag`` has the
    same fields; the port never imports it)."""
    return (type(x).__name__ == "Tag" and hasattr(x, "pos")
            and hasattr(x, "key") and hasattr(x, "val"))


def _host_value(v):
    """A numpy scalar as the Python value; anything else as it is."""
    return v.item() if isinstance(v, np.generic) else v


def _leaf(x, device: torch.device):
    if torch.is_tensor(x):
        return x.to(device)
    if _is_tag(x):
        return Tag(int(x.pos), x.key, _host_value(x.val))
    if not isinstance(x, (np.ndarray, np.generic)):
        return x  # Python ints, floats, bools, strings, tags: host-side
    a = np.asarray(x)
    if a.ndim == 0 and a.dtype.kind in "iu":
        return int(a)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_port(states, device: torch.device):
    if isinstance(states, dict):
        return {k: _to_port(v, device) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(_to_port(v, device) for v in states)
    return _leaf(states, device)


def state_from_jax(states, device="cuda"):
    """Streaming block state of the JAX package -> the port's, on
    ``device``.

    Walks dicts, lists and tuples (e.g. a checkpoint's ``{node: state}``,
    FirFilter's ``{"buf", "out_off"}``, SymbolSync's ``{"sync": {...}}``,
    the HDLC snapshot, StreamToPdu's ``{"mode", "buf", "tail_left",
    "tags"}``, ZeroCrossing's ``{"sync": {"last_sign", "last_cross",
    "counter"}}``).  numpy arrays and scalars become tensors on ``device``
    (the Scrambler's and Descrambler's uint8 registers, Vco's phase,
    SinglePoleIirFilter's y0, Delay's carried tail, an open burst,
    CorrelateAccessCode's tail of ``len(code) - 1`` bits, ZeroCrossing's
    ``last_cross``), except integer scalars (``out_off``, NrziDecode's bit,
    ZeroCrossing's ``counter``), which become Python ints; the JAX
    package's stream tags become the port's ``Tag``; host-side leaves —
    Python ints, floats, bools and strings, such as the HDLC snapshot's
    ``state``, ``cur`` and ``stats``, BurstTagger's ``last`` or
    RationalResampler's offsets — stay as they are.
    """
    return _to_port(states, target_device(device, "state_from_jax"))
