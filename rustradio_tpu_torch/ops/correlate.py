"""Access-code correlation (port of ``rustradio_tpu/ops/correlate.py``;
reference src/correlate_access_code.rs).

out[n] = 1 if the last len(code) bits ending at n differ from code in at
most ``allowed_diffs`` positions (0 while the window is not yet full).
The JAX package counts the matches with an f32 convolution; here each
window's differing bits are counted as integers over an ``unfold`` of the
bit stream, on the stream's device: exact, with no TF32 to turn off.
"""

from __future__ import annotations

import numpy as np
import torch


def correlate_access_code(x, code, allowed_diffs: int = 0) -> torch.Tensor:
    """Bit stream (u8 0/1 tensor) -> u8 0/1 match indicator per position,
    on the stream's device."""
    x = torch.as_tensor(x).to(torch.uint8)
    code = np.asarray(code, np.uint8)
    ncode = len(code)
    if ncode == 0:
        raise ValueError("access code must be nonempty")
    out = torch.zeros(x.shape[0], dtype=torch.uint8, device=x.device)
    if x.shape[0] >= ncode:
        windows = x.unfold(0, ncode, 1)  # (n - ncode + 1, ncode), a view
        diffs = (windows != torch.from_numpy(code).to(x.device)).sum(1)
        out[ncode - 1:] = (diffs <= allowed_diffs).to(torch.uint8)
    return out
