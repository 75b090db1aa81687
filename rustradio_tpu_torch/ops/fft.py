"""FFT ops on PDUs and streams (port of ``rustradio_tpu/ops/fft.py``), on
``torch.fft`` (cuFFT on the card).

* ``fft_pdu`` — FFT one burst, optional window + fftshift (reference
  src/fft.rs:18-46; window/shift options live on the block there).
* ``fft_stream`` — frame a stream into size-N chunks and FFT each frame
  (reference src/fft_stream.rs:74-118) as one batched FFT over a
  (nframes, size) view.  Returns the flattened frame stream, the number
  of frames and the leftover samples (< size), the caller's carry.

Each takes a tensor (and runs on its device) or a numpy array with
``device=``; a numpy array without ``device=`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import target_device


def as_stream(x, device, what: str, dtype=torch.complex64) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: a tensor stays on its device (moved to
    ``device`` when given), a numpy array needs ``device=``."""
    if torch.is_tensor(x):
        t = x if device is None else x.to(target_device(device, what))
        return t.to(dtype)
    if device is None:
        raise ValueError(f"{what}: a numpy input needs device= (the card, "
                         f'or device="cpu")')
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        target_device(device, what)).to(dtype)


def fft_pdu(x, window=None, shift: bool = False, device=None) -> torch.Tensor:
    """FFT of one PDU, complex64: ``window`` (an array of len(x)) applied
    first, the spectrum ``fftshift``-ed when ``shift``."""
    x = as_stream(x, device, "fft_pdu")
    if window is not None:
        x = x * torch.as_tensor(np.asarray(window, np.float32)).to(x.device)
    y = torch.fft.fft(x)
    if shift:
        y = torch.fft.fftshift(y)
    return y


def fft_stream(x, size: int, device=None):
    """Batched FFT frames.  Returns (flat_output, nframes, leftover)."""
    if size <= 0:
        raise ValueError("FFT size must be nonzero")
    x = as_stream(x, device, "fft_stream")
    nframes = x.shape[0] // size
    if nframes == 0:  # (an empty batch is no FFT for some backends)
        return x[:0], 0, x
    frames = x[: nframes * size].reshape(nframes, size)
    out = torch.fft.fft(frames, dim=-1)
    return out.reshape(-1), nframes, x[nframes * size:]
