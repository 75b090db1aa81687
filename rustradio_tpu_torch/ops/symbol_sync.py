"""Clock recovery (the ``recover_symbols`` entry point of
``rustradio_tpu/ops/symbol_sync.py``).

Zero-crossing timing error detector + clamped IIR clock filter (reference
src/symbol_sync.rs:115-218), run as the native C++ recurrence
``rr_symbol_sync`` (``native.symbol_sync_f32``): an exact f32 replication
of the JAX package's scan, so both packages emit the same symbols from the
same f32 input.  The recurrence is sequential and runs at the symbol
decision's low rate on the host; the dense front-end stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native


def recover_symbols(x, sps: float, max_deviation: float = 0.5,
                    clock_taps=(0.5, 0.5)) -> np.ndarray:
    """Symbol sync from a fresh state, returning the emitted symbols as a
    float32 numpy array.  A tensor on the card is copied to the host.
    Raises if the native library cannot be built."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return native.symbol_sync_f32(np.asarray(x, np.float32), sps,
                                  max_deviation, np.asarray(clock_taps))
