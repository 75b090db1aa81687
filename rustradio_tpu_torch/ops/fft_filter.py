"""FFT fast convolution by overlap-save (port of
``rustradio_tpu/ops/fft_filter.py``).

The reference implements overlap-ADD with fft_size = 2*next_pow2(ntaps)
(src/fft_filter.rs:36-42); its stream output is the full zero-history
convolution ``y[n] = sum_k taps[k] x[n-k]``.  Here, as in the JAX package,
overlap-SAVE: the stream (left-padded with ntaps-1 zeros) is cut into
overlapping frames (``Tensor.unfold``, a view), each frame goes through one
batched ``torch.fft`` (cuFFT on the card), a pointwise product with the
tap spectrum and the inverse FFT, and the last ``hop`` samples of each
frame are the output.  The FFT size grows with the input up to 32768
(``_pick_fft_size``), as the JAX package picks it.

``filter_float`` / ``filter_complex`` dispatch as the JAX package's
accelerator path does: real (or, for complex streams, real-valued complex)
taps up to ``kernels.MAX_TAPS`` go to ``kernels.fir_decimate`` (kernel A on
the card, its plain version on the CPU); longer or truly complex taps go
to overlap-save.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pick_fft_size(ntaps: int, n: int) -> int:
    """At least 2*next_pow2(ntaps) like the reference, grown up to 32768
    while it reduces total work for large inputs."""
    size = 2 * _next_pow2(ntaps)
    while size < 32768 and size * 2 - (ntaps - 1) < n:
        size *= 2
    return size


def overlap_save_frames(x: torch.Tensor, overlap: int, hop: int):
    """Frames of length overlap + hop at pitch ``hop`` over ``x`` left-padded
    with ``overlap`` zeros (and right-padded to whole frames).  Returns
    (frames, nblocks); frames is a (nblocks, overlap + hop) view."""
    n = x.shape[0]
    nblocks = -(-n // hop)
    xp = torch.cat([x.new_zeros(overlap), x,
                    x.new_zeros(nblocks * hop - n)])
    return xp.unfold(0, overlap + hop, hop), nblocks


def _spectrum(taps, fft_size: int, device, real: bool = False,
              scale: float = 1.0) -> torch.Tensor:
    """The taps' FFT, computed in float64 on the host, as complex64."""
    t = np.asarray(taps)
    if real:
        h = np.fft.rfft(np.asarray(t, np.float64), fft_size)
    else:
        h = np.fft.fft(np.asarray(t, np.complex128), fft_size)
    return torch.from_numpy((h / scale).astype(np.complex64)).to(device)


def fft_filter(x, taps, fft_size: int | None = None) -> torch.Tensor:
    """Full zero-history convolution y[n] = sum_k taps[k] x[n-k], x[<0] = 0,
    len(y) == len(x), complex64 (reference FftFilter,
    src/fft_filter.rs:289-354), to float32 FFT accuracy."""
    x = torch.as_tensor(x).to(torch.complex64)
    n, ntaps = x.shape[0], len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = _pick_fft_size(ntaps, n)
    hop = fft_size - overlap
    if hop <= 0:
        raise ValueError(f"fft_size {fft_size} too small for {ntaps} taps")
    frames, _ = overlap_save_frames(x, overlap, hop)
    spec = torch.fft.fft(frames, dim=-1) * _spectrum(taps, fft_size, x.device)
    conv = torch.fft.ifft(spec, dim=-1)
    return conv[:, overlap:].reshape(-1)[:n]


def fft_filter_decimate(x, taps, deci: int,
                        fft_size: int | None = None) -> torch.Tensor:
    """``fft_filter(x, taps)[::deci]`` in the frequency domain: decimation
    in time is aliasing in frequency, so each frame's spectrum is folded
    ``deci``-fold and a ``fft_size/deci``-point IFFT gives the decimated
    outputs of that frame.  ceil(n/deci) outputs, complex64."""
    if deci == 1:
        return fft_filter(x, taps, fft_size)
    x = torch.as_tensor(x).to(torch.complex64)
    n, ntaps = x.shape[0], len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = max(_pick_fft_size(ntaps, n), 4 * deci)
    if fft_size % deci:
        raise ValueError(f"fft_size {fft_size} not divisible by deci {deci}")
    # a hop of whole deci steps starts every frame on the global decimation
    # grid; the frame-local overlap o2 is then a multiple of deci too
    hop = (fft_size - overlap) // deci * deci
    o2 = fft_size - hop
    if hop <= 0:
        raise ValueError("fft_size too small for taps and deci")
    frames, nblocks = overlap_save_frames(x, o2, hop)
    spec = torch.fft.fft(frames, dim=-1) * _spectrum(taps, fft_size, x.device,
                                                      scale=deci)
    folded = spec.reshape(nblocks, deci, fft_size // deci).sum(dim=1)
    w = torch.fft.ifft(folded, dim=-1)  # w[b, u] = frame b's output deci*u
    ofs = o2 // deci
    return w[:, ofs : ofs + hop // deci].reshape(-1)[: -(-n // deci)]


def fft_filter_float(x, taps, fft_size: int | None = None) -> torch.Tensor:
    """Float-in/float-out FFT filter (reference FftFilterFloat,
    src/fft_filter.rs:357-491, which runs the complex filter and takes the
    real part); real taps use rfft/irfft."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):  # the reference takes float taps; guard anyway
        return fft_filter(torch.as_tensor(x).float(), taps, fft_size).real
    x = torch.as_tensor(x).to(torch.float32)
    n, ntaps = x.shape[0], len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = _pick_fft_size(ntaps, n)
    hop = fft_size - overlap
    if hop <= 0:
        raise ValueError(f"fft_size {fft_size} too small for {ntaps} taps")
    frames, _ = overlap_save_frames(x, overlap, hop)
    spec = torch.fft.rfft(frames, dim=-1) * _spectrum(taps, fft_size, x.device,
                                                       real=True)
    conv = torch.fft.irfft(spec, n=fft_size, dim=-1)
    return conv[:, overlap:].reshape(-1)[:n]


def filter_float(x, taps, fft_size: int | None = None) -> torch.Tensor:
    """Real-stream filter, the semantics of ``fft_filter_float`` (zero
    history, y[m] = sum_j taps[j] x[m-j]).  Real taps up to
    ``kernels.MAX_TAPS`` (an array or a ``kernels.TapSet``) run on
    ``kernels.fir_decimate`` at stride 1 (``fft_size`` is then unused);
    others use overlap-save."""
    if type(taps) is not kernels.TapSet:
        taps = np.asarray(taps)
    if not np.iscomplexobj(taps) and len(taps) <= kernels.MAX_TAPS:
        x = torch.as_tensor(x).to(torch.float32).contiguous()
        return kernels.fir_decimate(x, taps, 1)
    return fft_filter_float(x, taps, fft_size)


def filter_complex(x, taps, fft_size: int | None = None) -> torch.Tensor:
    """Complex-stream filter, the semantics of ``fft_filter`` (zero
    history).  Real or real-valued complex taps (``low_pass_complex``
    designs) up to ``kernels.MAX_TAPS`` run as two real
    ``kernels.fir_decimate`` passes over the I/Q planes; longer or truly
    complex taps use overlap-save."""
    taps = np.asarray(taps)
    if len(taps) <= kernels.MAX_TAPS and not np.any(np.imag(taps)):
        x = torch.as_tensor(x).to(torch.complex64)
        return kernels.fir_decimate(x, np.real(taps).astype(np.float32), 1)
    return fft_filter(x, taps, fft_size)
