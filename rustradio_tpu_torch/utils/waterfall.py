"""Spectrogram / waterfall rendering (port of
``rustradio_tpu/utils/waterfall.py``; the reference's UI visualizations:
rustradio-ui plots and the rtl_fm ratatui waterfall,
examples/rtl_fm.rs:81-120).

Device side: one batched ``torch.fft`` over the framed samples -> a dB
power matrix.  Host side: ``render_ascii`` (numpy, a copy of the JAX
package's) draws it as an ASCII waterfall, no display needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fft import as_stream

def spectrogram(x, fft_size: int = 1024, hop: int | None = None,
                window: str = "hanning", device=None) -> torch.Tensor:
    """(nframes, fft_size) power in dB, DC-centred, on ``x``'s device: a
    tensor, or a numpy array with ``device=`` (without it a numpy array
    raises).  Frames start every ``hop`` samples (``fft_size`` by
    default); each is windowed (numpy's window of that name, in f32)."""
    hop = hop or fft_size
    x = as_stream(x, device, "spectrogram")
    n = x.shape[0]
    nframes = max((n - fft_size) // hop + 1, 0)
    if nframes == 0:
        return torch.zeros((0, fft_size), dtype=torch.float32, device=x.device)
    frames = x[: (nframes - 1) * hop + fft_size].unfold(0, fft_size, hop)
    w = torch.from_numpy(getattr(np, window)(fft_size).astype(np.float32))
    spec = torch.fft.fftshift(torch.fft.fft(frames * w.to(x.device), dim=-1),
                              dim=-1)
    p = spec.real ** 2 + spec.imag ** 2
    return 10.0 * torch.log10(p + 1e-20)


_RAMP = " .:-=+*#%@"


def render_ascii(db: np.ndarray, width: int = 80, height: int = 24,
                 floor: float | None = None, ceil: float | None = None) -> str:
    """Render a dB matrix as an ASCII waterfall."""
    db = np.asarray(db)
    if db.size == 0:
        return "(no data)"
    # resample to (height, width)
    ri = np.linspace(0, db.shape[0] - 1, height).astype(int)
    ci = np.linspace(0, db.shape[1] - 1, width).astype(int)
    img = db[np.ix_(ri, ci)]
    lo = floor if floor is not None else np.percentile(img, 10)
    hi = ceil if ceil is not None else img.max()
    t = np.clip((img - lo) / max(hi - lo, 1e-9), 0, 1)
    chars = (t * (len(_RAMP) - 1)).astype(int)
    return "\n".join("".join(_RAMP[c] for c in row) for row in chars)
