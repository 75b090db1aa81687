"""Carry the JAX package's data across into the port, as numpy arrays.

The port never imports jax; these take what the JAX package produced
after ``np.asarray`` — packed planes and streaming block states — so a
test can start the port from JAX's data and check that both compute the
same stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels


def packed_from_jax(plane_np, precision: str, device="cpu") -> torch.Tensor:
    """An ``fm_plane_pack`` output of the JAX package ((rows, deci*128),
    bfloat16 via ml_dtypes, int8 or float32) as the port's 1-D packed
    plane: the same samples in the same order, a reshape plus a dtype
    view."""
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


def state_from_jax(states, device="cpu"):
    """Streaming block state of the JAX package -> the port's.

    Maps FirFilter's ``{"buf", "out_off"}`` and QuadratureDemod's
    1-sample carry (or a dict of such states, keyed by node) from numpy to
    tensors on ``device``; integer scalars (``out_off``) stay Python ints.
    """
    if isinstance(states, dict):
        return {k: state_from_jax(v, device) for k, v in states.items()}
    a = np.asarray(states)
    if a.ndim == 0 and a.dtype.kind in "iu":
        return int(a)
    return torch.from_numpy(np.array(a, copy=True)).to(device)
