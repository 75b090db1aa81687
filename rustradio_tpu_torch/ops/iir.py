"""IIR filters (port of ``rustradio_tpu/ops/iir.py``).

``single_pole_iir``: y[n] = alpha*x[n] + (1-alpha)*y[n-1], y[-1] = 0
(reference src/single_pole_iir_filter.rs:31-44).  The JAX package runs the
linear first-order recurrence as an associative scan; torch has none, so
here it is a blocked closed form: the stream is cut into blocks of
``_BLOCK`` samples, each block's zero-carry solution is one matrix product
with the lower-triangular matrix of powers of (1-alpha), and the carries
between blocks are the same recurrence over the blocks' last values, at
multiplier (1-alpha)^_BLOCK, solved the same way (log_BLOCK(n) levels).
Plain torch on the input's device; no kernel.

``iir_filter``: the reference's "IIR" (src/iir_filter.rs:84-101), y[n] =
taps[0]*x[n] + sum_{i>=1} taps[i]*y[n-i], any order up to
``kernels.MAX_IIR_ORDER``.  The JAX package runs it as a ``lax.scan``;
here it is kernel G (``kernels.iir_scan``) on the card and its plain
version on the CPU: the same linear recurrence cut into chunks of
``kernels.IIR_CHUNK`` samples that walk at once, each from the state a
fixed scan of the chunks' affine maps gives it (the first chunk from
``history``, so it is the sequential form itself).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fft import as_stream

_BLOCK = 128


def _powers(c: float, n: int) -> np.ndarray:
    """c^0 .. c^(n-1) in float64."""
    return np.power(np.float64(c), np.arange(n, dtype=np.float64))


def _first_order(u: torch.Tensor, c: float) -> torch.Tensor:
    """y[n] = c*y[n-1] + u[n], y[-1] = 0, over a 1-D tensor."""
    n = u.shape[0]
    b = min(_BLOCK, max(n, 1))
    nb = -(-n // b)
    pw = _powers(c, b + 1)
    k = np.arange(b)
    # tri[j, k] = c^(k-j) for k >= j: row vector times tri solves a block
    lag = k[None, :] - k[:, None]
    tri = np.where(lag >= 0, pw[np.clip(lag, 0, b)], 0.0)
    tri_t = torch.from_numpy(tri).to(u.device, dtype=u.real.dtype)
    if u.is_complex():
        tri_t = tri_t.to(u.dtype)
    blocks = torch.nn.functional.pad(u, (0, nb * b - n)).reshape(nb, b)
    with kernels._true_f32():
        local = blocks @ tri_t
    if nb > 1:
        ends = _first_order(local[:, -1].contiguous(), float(pw[b]))
        carry = torch.cat([ends.new_zeros(1), ends[:-1]])
        grow = torch.from_numpy(pw[1:]).to(u.device, dtype=u.real.dtype)
        local = local + carry[:, None] * grow[None, :]
    return local.reshape(-1)[:n]


def single_pole_iir(x, alpha: float, y0=None) -> torch.Tensor:
    """First-order low-pass, y[n] = alpha*x[n] + (1-alpha)*y[n-1].

    ``y0`` is the carried previous output (a scalar or 0-d tensor) for
    streaming; defaults to 0.  On ``x``'s device."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha {alpha} out of [0,1]")
    x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    real = x.real.dtype
    # (1 - alpha) in the stream's precision, as the JAX package takes it
    c = float(torch.tensor(1.0 - float(alpha), dtype=real))
    y = _first_order(x * float(alpha), c)
    if y0 is None:
        return y
    grow = torch.from_numpy(_powers(c, x.shape[0] + 1)[1:]).to(x.device, real)
    return torch.as_tensor(y0, device=x.device).to(y.dtype) * grow + y


def iir_filter(x, taps, history=None, device=None) -> torch.Tensor:
    """Reference IirFilter (src/iir_filter.rs:84-101), order len(taps)-1:
    y[n] = taps[0]*x[n] + sum_{i>=1} taps[i]*y[n-i].  ``history`` (the last
    outputs, most recent first) carries a stream on; zeros by default.
    Order 0 is ``x * taps[0]`` and launches nothing.  f32 on ``x``'s
    device: a tensor, or a numpy array with ``device=``."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    order = len(taps) - 1
    x = as_stream(x, device, "iir_filter", torch.float32).contiguous()
    if order == 0:
        return x * float(taps[0])
    if history is None:
        h = torch.zeros(order, dtype=torch.float32, device=x.device)
    else:
        h = torch.as_tensor(history, dtype=torch.float32).to(x.device).reshape(-1)
    return kernels.iir_scan(x, taps, h)
