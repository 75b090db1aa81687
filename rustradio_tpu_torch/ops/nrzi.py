"""NRZI-S encode/decode (port of ``rustradio_tpu/ops/nrzi.py``; reference
src/nrzi.rs).

Decode (src/nrzi.rs:37-42): out[n] = 1 ^ x[n] ^ x[n-1], x[-1] = ``last``.
Encode (src/nrzi.rs:64-69): the line toggles on each input 0, so out[n] is
the parity of the zeros in x[0..n] (plus ``out0``): a prefix sum.
"""

from __future__ import annotations

import torch


def nrzi_decode(x, last: int = 0):
    """out[n] = 1 ^ x[n] ^ x[n-1]; ``last`` is the carried previous bit."""
    x = torch.as_tensor(x).to(torch.uint8)
    prev = torch.cat([x.new_full((1,), last), x[:-1]])[: x.shape[0]]
    return 1 ^ x ^ prev


def nrzi_encode(x, out0: int = 0):
    """NRZI-S encode; ``out0`` is the carried current line state."""
    x = torch.as_tensor(x).to(torch.uint8)
    toggles = (x == 0).to(torch.int64)
    return ((torch.cumsum(toggles, 0) + out0) % 2).to(torch.uint8)
