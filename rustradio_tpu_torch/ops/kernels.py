"""The port's CUDA kernels, their plain PyTorch versions, and the
host-side geometry around them (port of
``rustradio_tpu/ops/pallas_kernels.py``).

Three hand-written kernels, built from ``csrc/`` by :mod:`.cuda_lib`;
A and B share one register-blocked FIR core, ``csrc/fir_core.cuh``:

* ``fir_decimate`` (``csrc/fir_decimate.cu``, kernel A) replaces
  ``_fir_band_kernel`` (pallas_kernels.py:202): a decimating real FIR,
  y[m] = sum_j taps[j] x[m*deci - j], zero history, ceil(n/deci) outputs,
  true f32, over the rows of a (rows, n) tensor in one launch.  A complex
  stream is its I and Q planes as two rows: one launch for real taps, two
  for complex ones.
* ``fm_chain_span`` (``csrc/fm_chain.cu``, kernel B) replaces
  ``_fm_chain_kernel`` (:394), ``_fm_i8_kernel`` (:448) and
  ``_fm_chain_db_kernel`` (:553): the FIR on both I/Q planes, the DC fold
  and the polynomial-atan2 discriminator in one pass, over any span of
  outputs, with a seed in and the last filtered sample out.  ``fm_chain``
  (flat or packed planes) and ``fm_chain_window`` (a window of a packed
  ring) are built on it.
* ``quad_demod_fast`` (``csrc/quad_demod.cu``, kernel C) replaces
  ``_quad_kernel`` (:91): gain * fast_atan2 of conj(x[k]) * x[k+1] over a
  complex64 stream, n - 1 outputs.

Two more have no Pallas counterpart: they replace the ``lax.scan``s of the
clock recovery (``rustradio_tpu/ops/symbol_sync.py``), one block per
channel in which one lane walks the recurrence on registers and shared
memory while other warps load the next tile and write the previous one
out (``csrc/symbol_sync.cu`` on ``csrc/sync_core.cuh``):

* ``symbol_sync_events_scan`` (kernel D) runs the event step over each
  channel's crossing slots (the scan at symbol_sync.py:305);
* ``symbol_sync_scan`` (kernel E) runs the per-sample recurrence (the scan
  at symbol_sync.py:145, and native ``rr_symbol_sync``).

Two more replace the other per-sample ``lax.scan``s:

* ``cma_scan`` (``csrc/cma.cu``, kernel F) runs the CMA equalizer's
  recurrence (``rustradio_tpu/ops/cma.py:45``) in its delayed-update form
  in one block: over blocks of ``CMA_BLOCK`` windows, producer warps
  compute the windows' lag sums and a walker warp walks window i on lane
  i, a window's chain one shuffle and eight f32 operations;
* ``iir_scan`` (``csrc/iir.cu``, kernel G) runs the reference's IIR
  filter (``rustradio_tpu/ops/iir.py:68``) as a chunked scan over every
  SM: chunks of ``IIR_CHUNK`` samples walk at once, their starting states
  from a scan of the chunks' affine maps.

``tools/csrc/symbol_sync_lone.cu`` keeps D and E as one thread per channel,
and ``tools/csrc/chain_calib.cu`` measures a lone lane's latencies:
yardsticks that ``tools/time_sync.py`` builds into a library of its own
(for itself and ``chip_smoke.py``); the package's library holds neither.

Routing: a wrapper runs the plain version only because its tensor lies on
the CPU.  For a CUDA tensor it launches the kernel or raises; nothing
falls back.  ``*_plain`` are the plain versions themselves, callable on
any device (the chip smoke test holds each kernel against them on the
card).  Every kernel launch adds one to ``LAUNCHES[name]``, and every
wrapper call its work (bytes and operations, ``*_work``) to ``WORK``.
Inside ``recording()`` (the region a CUDA graph captures, where a
wrapper's call is recorded and nothing runs, and the warm-up before it)
both go to a :class:`LaunchRecord` instead, and ``replayed(record)`` adds
them after each replay of the graph (``Graph.compile_device_loop`` and
``Graph.run_stream(scan_chunks=)`` on the card).

Taps: every wrapper takes an array or a :class:`TapSet`, the record of a
real tap set with what is derived from it (device copies of the effective
taps, fold constants, packed geometries) made once.  An array is looked up
by content per call (``tapset``); blocks, lowering plans and the FM models
hold their TapSet, so the hot paths recompute nothing per call.

How it is run.  The CPU tests (``python -m pytest tests/test_torch_*.py``)
hold the plain versions to the JAX package; the kernels run only on an
NVIDIA GPU, where ``python3 chip_smoke.py`` (the end-to-end drive) and
``python -m pytest tests/test_torch_cuda.py`` (kernels against plain
versions, edge cases of the register-blocked core and of the clock
recovery's tiles, graph replay against the eager loop) build them at
first use.

Precision modes keep the JAX package's contracts (plane dtype and error
budget against float64), not its MXU mechanics:

=========  ==========  ===========================================
mode       plane       taps the kernel multiplies with (f32)
=========  ==========  ===========================================
highest    float32     the taps
split3     float32     the taps
w3 / w2    bfloat16    sum of the 3 / 2 exact bf16 terms of each tap
i8         int8        sum_k d_k s_k of the 3-term scaled-s8 ladder
=========  ==========  ===========================================

bf16 and int8 planes are exact only for 8-bit-sourced data on the
(u8 - 127)/128 wire grid; an int8 plane value v means x = (v + 1)/128.

Packed planes (``fm_plane_pack``) are the flat form of the JAX layout:
``wlen - 1`` zero-history samples (0, or -1 for int8), the samples, then
trailing pad up to ``fm_pack_geometry(...).total`` — one 1-D tensor in
the working dtype, written once at ingest.
"""

from __future__ import annotations

import contextlib
import functools
import typing

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib
from .demod import demod_pairs

LAUNCHES = {"fir_decimate": 0, "fm_chain": 0, "quad_demod": 0,
            "symbol_sync_events": 0, "symbol_sync_scan": 0, "cma": 0,
            "iir": 0}



class LaunchRecord(typing.NamedTuple):
    """What the wrappers did inside one ``recording()``: the launches per
    kernel, the TapSets of those launches, whose device taps the recorded
    launches point into and which live as long as the record, and the
    launches' work (``{"bytes", "flops"}``, as :data:`WORK` counts it)."""
    counts: dict
    tapsets: list
    work: dict


#: The work of the kernels' calls so far: bytes each call must move and
#: its f32 operations, from the call's shapes (``*_work`` below).  A
#: wrapper adds its call's work on both routes (the plain version does the
#: kernel's work on the CPU); ``LAUNCHES`` counts launches on the card only.
WORK = {"bytes": 0.0, "flops": 0.0}

_record: LaunchRecord | None = None


def active_work() -> dict:
    """The work accumulator that a wrapper's call adds to now: the open
    ``recording()``'s, else :data:`WORK`."""
    return WORK if _record is None else _record.work


def _worked(work) -> None:
    acc = active_work()
    acc["bytes"] += work[0]
    acc["flops"] += work[1]


def _launched(name: str, taps: "TapSet | None" = None, work=(0.0, 0.0)) -> None:
    """Count one launch of kernel ``name``, made with ``taps`` on the
    device, and its ``work`` (bytes, operations): into ``LAUNCHES`` and
    :data:`WORK`, or into the open ``recording()``."""
    _worked(work)
    if _record is None:
        LAUNCHES[name] += 1
        return
    _record.counts[name] = _record.counts.get(name, 0) + 1
    if taps is not None and not any(t is taps for t in _record.tapsets):
        _record.tapsets.append(taps)


@contextlib.contextmanager
def recording():
    """Counts apart.  Around the region that a CUDA graph captures, a
    wrapper's call records its launch into the graph and runs nothing, so
    it counts into the yielded :class:`LaunchRecord` and not into
    ``LAUNCHES``; hold the record with the graph and call
    ``replayed(record)`` after each replay.  Around a capture's warm-up the
    launches run, but they belong to the capture, not to the stream, and
    are counted apart the same way."""
    global _record
    if _record is not None:
        raise RuntimeError("kernels.recording() does not nest")
    record = _record = LaunchRecord({}, [], {"bytes": 0.0, "flops": 0.0})
    try:
        yield record
    finally:
        _record = None


def replayed(record: LaunchRecord) -> None:
    """Add the launches and the work of one replay of ``record``'s graph to
    ``LAUNCHES`` and :data:`WORK`."""
    for name, count in record.counts.items():
        LAUNCHES[name] += count
    WORK["bytes"] += record.work["bytes"]
    WORK["flops"] += record.work["flops"]


# ---------------------------------------------------------- work counts
# One count of each kernel's work, read by Graph.costs() (through the
# wrappers, per call) and by chip_smoke.py's bounds (at its own shapes and
# with its data's counts): (bytes, f32 operations).  Each input is read once
# and each output written once; the taps are left out.

def fir_work(n: int, ntaps: int, deci: int, rows: int = 1):
    """Kernel A: n f32 in and ceil(n/deci) out per row, ntaps FMA each."""
    m = -(-n // deci)
    return float(rows * 4 * (n + m)), float(rows * 2 * m * ntaps)


def fm_chain_work(count: int, ntaps: int, deci: int, plane_bytes: int):
    """Kernel B: count * deci samples of each of two planes in (at
    ``plane_bytes`` a sample), count f32 out, ntaps FMA per plane and
    output."""
    return (float(2 * count * deci * plane_bytes + 4 * count),
            float(2 * 2 * count * ntaps))


def quad_work(n: int):
    """Kernel C: n complex64 in, n - 1 f32 out (its operations are not
    counted: the bytes bound it)."""
    return float(8 * n + 4 * max(n - 1, 0)), 0.0


def d_slot_work(order: int) -> int:
    """Kernel D's f32 operations at one real slot (a crossing), clock
    filter of ``order`` + 1 taps."""
    return 30 + order


def e_crossing_work(order: int) -> int:
    """Kernel E's f32 operations at one crossing."""
    return 15 + order


def events_work(slots: int, real_slots: int, order: int):
    """Kernel D: the slots' int32 positions in, the mid offset and the
    clock of each slot out; ``real_slots`` of them hold a crossing."""
    return float(12 * slots), float(real_slots * d_slot_work(order))


def scan_work(samples: int, sps: float, crossings: int, order: int):
    """Kernel E: f32 samples in, a mask byte and a clock out; one
    operation a sample, two an emission (one a symbol), and
    ``e_crossing_work`` a crossing."""
    return (float(9 * samples),
            float(samples + 2 * samples / sps + crossings * e_crossing_work(order)))


PRECISIONS = ("highest", "split3", "w3", "w2", "i8")
MAX_TAPS = 4096  # the kernels' bound, as ops/fir.py:74 in the JAX package
_PLANE_DTYPE = {"highest": torch.float32, "split3": torch.float32,
                "w3": torch.bfloat16, "w2": torch.bfloat16, "i8": torch.int8}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def plane_dtype(precision: str) -> torch.dtype:
    try:
        return _PLANE_DTYPE[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}; have "
                         f"{PRECISIONS}") from None


# ------------------------------------------------------------ host side

def fir_window(ntaps: int, deci: int) -> int:
    """Taps rounded up to a multiple of deci (the packed history is
    wlen - 1 samples, as in the JAX layout)."""
    return -(-ntaps // deci) * deci


class PackGeometry(typing.NamedTuple):
    wlen: int       # fir_window(ntaps, deci)
    tile_rows: int  # normalized tile height (rows of 128 outputs)
    g: int          # tiles covering the m outputs
    m: int          # outputs, ceil(n / deci)
    step: int       # input samples per packed row, deci * 128
    total: int      # packed plane length


def fm_pack_geometry(n: int, taps, deci: int,
                     tile_rows: int | None = None) -> PackGeometry:
    """Size of the packed plane for n samples: the same numbers as
    ``_fm_pack_geometry`` (pallas_kernels.py:695), so packed planes carry
    across from the JAX package unchanged."""
    wlen = fir_window(len(taps), deci)
    nshift = (deci * 127 + wlen - 1) // 128 + 1
    nq = -(-nshift // deci)
    tile_rows = max(1024 if tile_rows is None else tile_rows, nq)
    tile_rows += (-tile_rows) % 16
    m = -(-n // deci)
    g = -(-(-(-m // 128)) // tile_rows)
    nqp = nq + (-nq) % 8
    step = deci * 128
    return PackGeometry(wlen, tile_rows, g, m, step, (g * tile_rows + nqp) * step)


def _round_bf16(a: np.ndarray) -> np.ndarray:
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def w_split_bf16(taps, terms: int) -> list[np.ndarray]:
    """Exact bf16 split of the taps: taps ~= sum(parts), each part exactly
    representable in bf16 (``_w_split_bf16``, pallas_kernels.py:652)."""
    r = np.asarray(taps, np.float32)
    parts = []
    for _ in range(terms):
        h = _round_bf16(r)
        parts.append(h)
        r = r - h
    return parts


def w_split_s8(taps, terms: int):
    """Scaled-s8 ladder taps ~= sum_k d_k s_k, s_k int8, d_k f32
    (``_w_split_s8``, pallas_kernels.py:667).  Returns (mats, scales)."""
    r = np.asarray(taps, np.float64)
    mats, scales = [], []
    for _ in range(terms):
        m = np.max(np.abs(r))
        if m == 0:
            m = 1.0
        d = np.float32(m / 127.0)
        s = np.clip(np.round(r / np.float64(d)), -127, 127).astype(np.int8)
        mats.append(s)
        scales.append(float(d))
        r = r - s.astype(np.float64) * np.float64(d)
    return mats, tuple(scales)


def effective_taps(taps, precision: str) -> np.ndarray:
    """The f32 taps the kernel multiplies with under ``precision``."""
    plane_dtype(precision)
    taps = np.asarray(taps, np.float32)
    if precision in ("w2", "w3"):
        parts = w_split_bf16(taps, 2 if precision == "w2" else 3)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out.astype(np.float32)
    if precision == "i8":
        mats, scales = w_split_s8(taps, 3)
        return sum(s.astype(np.float64) * d for s, d in zip(mats, scales)
                   ).astype(np.float32)
    return taps


class TapSet:
    """A real f32 tap set with what the wrappers derive from it, made once:
    the reversed effective taps per precision and device, the DC-fold
    constants and the packed-plane geometries.  ``tapset(taps)`` finds or
    makes the record of an array; blocks and models hold theirs, so a call
    with a TapSet recomputes nothing (and its device taps stay alive as
    long as it does, which a captured CUDA graph relies on)."""

    __slots__ = ("taps", "_sum", "_trev", "_consts", "_geo")

    def __init__(self, taps: np.ndarray):
        self.taps = taps
        self.taps.setflags(write=False)
        self._sum = np.float32(np.sum(taps, dtype=np.float64))
        self._trev: dict = {}
        self._consts: dict = {}
        self._geo: dict = {}

    def __len__(self) -> int:
        return len(self.taps)

    def __array__(self, dtype=None, copy=None):
        return self.taps if dtype is None else self.taps.astype(dtype)

    def trev(self, precision: str, device) -> torch.Tensor:
        """Reversed effective taps on ``device``."""
        key = (precision, device)
        t = self._trev.get(key)
        if t is None:
            rev = effective_taps(self.taps, precision)[::-1].copy()
            t = self._trev[key] = torch.from_numpy(rev).to(device)
        return t

    def consts(self, precision: str, offset: float):
        """(scale, dc) of the post-dot fold y = acc*scale + dc, in f32 as
        the TPU kernels compute them (pallas_kernels.py:441, :456, :601)."""
        key = (precision, offset)
        c = self._consts.get(key)
        if c is None:
            off = np.float32(offset)
            if precision == "i8":
                c = 1.0 / 128.0, float((np.float32(1.0 / 128.0) + off) * self._sum)
            else:
                c = 1.0, float(off * self._sum)
            if len(self._consts) >= 64:
                self._consts.clear()
            self._consts[key] = c
        return c

    def geometry(self, n: int, deci: int, tile_rows: int | None) -> PackGeometry:
        key = (n, deci, tile_rows)
        g = self._geo.get(key)
        if g is None:
            if len(self._geo) >= 64:
                self._geo.clear()
            g = self._geo[key] = fm_pack_geometry(n, self.taps, deci, tile_rows)
        return g


_tapsets: dict = {}


def tapset(taps) -> TapSet:
    """The :class:`TapSet` of real taps (a TapSet passes through), found
    by content among the 64 last made.  Complex taps must have a zero
    imaginary part."""
    if type(taps) is TapSet:
        return taps
    a = np.asarray(taps)
    if np.iscomplexobj(a):
        if np.any(np.imag(a)):
            raise ValueError("the FM chain needs real taps")
        a = np.real(a)
    a = np.ascontiguousarray(a, np.float32)
    key = a.tobytes()
    ts = _tapsets.get(key)
    if ts is None:
        if len(_tapsets) >= 64:
            _tapsets.clear()
        ts = _tapsets[key] = TapSet(a.copy())
    return ts


def to_s8(x: torch.Tensor) -> torch.Tensor:
    """f32 wire-grid plane ((u8 - 127)/128 levels) -> its exact s8 image
    u8 - 128.  Off-grid values are clamped to the nearest level."""
    return (torch.clamp(torch.round(x.float() * 128.0), -127.0, 128.0) - 1.0
            ).to(torch.int8)


def plane_cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A flat f32 plane in the working dtype of ``precision``."""
    dt = plane_dtype(precision)
    if dt == torch.int8:
        return to_s8(x)
    return x.to(dt)


def fm_plane_pack(x: torch.Tensor, taps, deci: int,
                  tile_rows: int | None = None,
                  precision: str = "w3") -> torch.Tensor:
    """Pack one I/Q plane once, at ingest, into the 1-D packed layout on
    ``x``'s device (see the module docstring).  Pass the result to
    ``fm_chain(..., n=n)`` or ``fm_chain_window``."""
    n = x.shape[0]
    geo = fm_pack_geometry(n, taps, deci, tile_rows)
    plane = plane_cast(x, precision)
    out = torch.full((geo.total,), -1 if plane.dtype == torch.int8 else 0,
                     dtype=plane.dtype, device=x.device)
    out[geo.wlen - 1 : geo.wlen - 1 + n] = plane
    return out


# ------------------------------------------------------ launch plumbing

def _stream(device) -> int:
    """The current stream's handle: the raw call, which builds no Stream
    object (several microseconds of each wrapper call otherwise)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _route(t: torch.Tensor) -> bool:
    """True when ``t`` must go through a CUDA kernel; False for the plain
    version (CPU tensors only)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


@contextlib.contextmanager
def _true_f32():
    """f32 convolutions without TF32: cuDNN takes TF32 for f32 convolutions
    by default on the card (and a matmul-based fallback would read the
    cuBLAS flag), which keeps only ~3 decimal digits.  Both are switched
    off for the plain versions and restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def _strided_fir(seg: torch.Tensor, trev: torch.Tensor, deci: int):
    """z[o] = sum_k trev[k] seg[o*deci + k], in f32 (conv1d, no TF32)."""
    with _true_f32():
        return F.conv1d(seg[None, None], trev[None, None], stride=deci)[0, 0]


# ------------------------------------------------ kernel A: fir_decimate

def _check_fir(x: torch.Tensor, taps: TapSet, deci: int) -> None:
    if x.dim() not in (1, 2) or x.dtype != torch.float32:
        raise ValueError(f"fir_decimate needs 1-D float32 (or complex) "
                         f"samples, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fir_decimate needs a contiguous tensor")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"fir_decimate takes 1..{MAX_TAPS} taps, got {len(taps)}")
    if deci < 1:
        raise ValueError(f"deci must be >= 1, got {deci}")


def _fir_planes_plain(x: torch.Tensor, taps: TapSet, deci: int):
    """Plain version of :func:`_fir_planes`: the rows as the batch of one
    strided convolution."""
    _check_fir(x, taps, deci)
    ntaps, n = len(taps), x.shape[-1]
    m = -(-n // deci)
    if m == 0 or x.numel() == 0:  # as the kernel: no outputs
        return x.new_zeros((*x.shape[:-1], m))
    trev = taps.trev("highest", x.device)
    xp = F.pad(x, (ntaps - 1, m * deci - n))
    with _true_f32():
        y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), trev[None, None],
                     stride=deci)
    return y.reshape(*x.shape[:-1], m)


def _fir_planes(x: torch.Tensor, taps: TapSet, deci: int):
    """The same real FIR over ``x`` (n,) -> (m,), or over every row of
    ``x`` (rows, n) -> (rows, m): one kernel A launch on CUDA tensors, the
    plain version on CPU ones."""
    _check_fir(x, taps, deci)
    n = x.shape[-1]
    rows = x.shape[0] if x.dim() == 2 else 1
    work = fir_work(n, len(taps), deci, rows)
    if not _route(x):
        _worked(work)
        return _fir_planes_plain(x, taps, deci)
    m = -(-n // deci)
    y = torch.empty((*x.shape[:-1], m), dtype=torch.float32, device=x.device)
    if m == 0 or rows == 0:
        return y
    trev = taps.trev("highest", x.device)
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_fir_decimate(
        x.data_ptr(), rows, n, trev.data_ptr(), len(taps), deci, y.data_ptr(),
        m, _stream(x.device)), "fir_decimate")
    _launched("fir_decimate", taps, work)
    return y


def _complex_split(planes_fn, x: torch.Tensor, taps, deci: int):
    """A real or complex stream through real or complex taps on
    ``planes_fn``: the I and Q planes of a complex stream go through real
    taps as the two rows of ONE call, through complex taps as two calls
    (real and imaginary taps)."""
    if x.dim() != 1:
        raise ValueError(f"fir_decimate needs a 1-D stream, got {tuple(x.shape)}")
    complex_taps = type(taps) is not TapSet and np.iscomplexobj(taps)
    if complex_taps:
        tr = tapset(np.real(taps))
        ti = tapset(np.imag(taps)) if np.any(np.imag(taps)) else None
    else:
        tr, ti = tapset(taps), None
    if not x.is_complex():
        re = planes_fn(x, tr, deci)
        if not complex_taps:
            return re
        return torch.complex(re, torch.zeros_like(re) if ti is None
                             else planes_fn(x, ti, deci))
    # (n, 2) interleaved -> (2, n) planes in one copy
    planes = torch.view_as_real(x.to(torch.complex64)).t().contiguous()
    a = planes_fn(planes, tr, deci)  # [xr*tr, xi*tr]
    if ti is None:
        return torch.complex(a[0], a[1])
    b = planes_fn(planes, ti, deci)  # [xr*ti, xi*ti]
    return torch.complex(a[0] - b[1], b[0] + a[1])


def fir_decimate(x: torch.Tensor, taps, deci: int) -> torch.Tensor:
    """Decimating FIR y[m] = sum_j taps[j] x[m*deci - j] with zero history
    and ceil(n/deci) outputs (f32, or complex64 for complex input/taps).
    Kernel A on CUDA tensors (one launch per real tap set, the I and Q
    planes of complex input together); the plain version on CPU tensors."""
    return _complex_split(_fir_planes, x, taps, deci)


def fir_decimate_plain(x: torch.Tensor, taps, deci: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fir_decimate` (any device)."""
    return _complex_split(_fir_planes_plain, x, taps, deci)


# ---------------------------------------------- kernel B: fm_chain_span

def _check_span(xr, xi, taps, deci, count, precision) -> None:
    dt = plane_dtype(precision)
    for p in (xr, xi):
        if p.dim() != 1 or p.dtype != dt:
            raise ValueError(f"precision {precision!r} needs 1-D {dt} planes, "
                             f"got {tuple(p.shape)} {p.dtype}")
        if not p.is_contiguous():
            raise ValueError("fm_chain needs contiguous planes")
    if xr.shape != xi.shape or xr.device != xi.device:
        raise ValueError("I/Q planes differ in length or device")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"fm_chain takes 1..{MAX_TAPS} taps, got {len(taps)}")
    if deci < 1 or count < 0:
        raise ValueError(f"bad deci {deci} or count {count}")


def _seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as 2 floats on its own device (a tensor) or ``device``."""
    if seed is None:
        return torch.zeros(2, dtype=torch.float32, device=device)
    if torch.is_tensor(seed):
        return seed.to(torch.float32).reshape(2).contiguous()
    return torch.tensor(seed, dtype=torch.float32, device=device).reshape(2)


def _plane_window(x: torch.Tensor, lo: int, hi: int, pad: float):
    """x[lo:hi] as f32, with ``pad`` at positions outside the plane."""
    a, b = max(lo, 0), min(hi, x.shape[0])
    if a >= b:
        return torch.full((hi - lo,), pad, dtype=torch.float32, device=x.device)
    return F.pad(x[a:b].float(), (a - lo, hi - b), value=pad)


def fm_chain_span_plain(xr, xi, taps, deci: int, gain: float = 1.0, *,
                        first: int, count: int, shift: int,
                        precision: str = "highest", offset: float = 0.0,
                        seed=None):
    """Plain PyTorch version of :func:`fm_chain_span` (any device)."""
    taps = tapset(taps)
    _check_span(xr, xi, taps, deci, count, precision)
    ntaps = len(taps)
    scale, dc = taps.consts(precision, offset)
    pad = -1.0 if xr.dtype == torch.int8 else 0.0
    trev = taps.trev(precision, xr.device)
    lo = (first - 1) * deci + shift
    hi = (first + count - 1) * deci + shift + ntaps
    # y[first-1 .. first+count-1]: count + 1 filtered samples
    yr = _strided_fir(_plane_window(xr, lo, hi, pad), trev, deci) * scale + dc
    yi = _strided_fir(_plane_window(xi, lo, hi, pad), trev, deci) * scale + dc
    s = _seed_tensor(seed, xr.device)
    yr = torch.cat([s[:1], yr[1:]])
    yi = torch.cat([s[1:], yi[1:]])
    audio = demod_pairs(yr[:-1], yi[:-1], yr[1:], yi[1:], gain)
    return audio, torch.stack([yr[-1], yi[-1]])


def fm_chain_span(xr, xi, taps, deci: int, gain: float = 1.0, *,
                  first: int, count: int, shift: int,
                  precision: str = "highest", offset: float = 0.0, seed=None):
    """Kernel B over outputs [first, first + count) of two planes in the
    working dtype of ``precision``.

    Filtered sample o is
    ``y[o] = scale * sum_k taps[ntaps-1-k] * X[o*deci + shift + k] + dc``
    (X the plane value, the pad value outside the plane; scale and dc fold
    the int8 grid and ``offset`` post-dot), and
    ``out[j] = gain * fast_atan2(conj(y[first+j-1]) * y[first+j])`` with
    ``y[first-1]`` taken from ``seed`` (2 floats; zeros if None).

    ``shift = 1 - ntaps`` reads a flat plane on the full-convolution grid,
    ``shift = 0`` on the valid grid, and ``shift = wlen - ntaps`` reads a
    packed plane.  Returns ``(audio, last)``: ``count`` f32 outputs and
    ``last = y[first + count - 1]`` as 2 floats.
    """
    taps = tapset(taps)
    _check_span(xr, xi, taps, deci, count, precision)
    work = fm_chain_work(count, len(taps), deci, xr.element_size())
    if not _route(xr):
        _worked(work)
        return fm_chain_span_plain(xr, xi, taps, deci, gain, first=first,
                                   count=count, shift=shift,
                                   precision=precision, offset=offset,
                                   seed=seed)
    dev = xr.device
    if seed is not None:
        seed = _seed_tensor(seed, dev)
        if seed.device != dev:
            raise ValueError(f"seed on {seed.device}, planes on {dev}")
    if count == 0:
        return (torch.empty(0, dtype=torch.float32, device=dev),
                _seed_tensor(seed, dev).clone())
    scale, dc = taps.consts(precision, offset)
    trev = taps.trev(precision, dev)
    out = torch.empty(count, dtype=torch.float32, device=dev)
    last = torch.empty(2, dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    # a null seed pointer is the zero seed: no fill is launched for it
    cuda_lib.check(lib.rr_fm_chain(
        _DTYPE_CODE[xr.dtype], xr.data_ptr(), xi.data_ptr(), xr.shape[0],
        shift, -1.0 if xr.dtype == torch.int8 else 0.0, trev.data_ptr(),
        len(taps), deci, first, count, scale, dc, float(gain),
        None if seed is None else seed.data_ptr(),
        out.data_ptr(), last.data_ptr(), _stream(dev)), "fm_chain")
    _launched("fm_chain", taps, work)
    return out, last


def fm_chain(xr, xi, taps, deci: int, gain: float = 1.0,
             tile_rows: int | None = None, offset: float = 0.0,
             precision: str = "highest", n: int | None = None):
    """The whole FM receive chain in one pass (``pallas_fm_chain``):
    ``quadrature_demod(fir_decimate(x), gain)`` with the polynomial atan2,
    m - 1 outputs for m = ceil(n/deci).

    Flat planes (``n=None``): f32 I/Q planes, cast to the working dtype of
    ``precision`` here.  Packed planes: pass ``fm_plane_pack`` outputs and
    the true sample count ``n=``; ``tile_rows`` must match the packing.
    ``offset`` is a DC offset folded in after the dot (filter(x + c) =
    filter(x) + c*sum(taps)), applied under the zero history too.
    """
    taps = tapset(taps)
    ntaps = len(taps)
    if n is None:
        pr, pi = plane_cast(xr, precision), plane_cast(xi, precision)
        m = -(-xr.shape[0] // deci)
        shift = 1 - ntaps
    else:
        geo = taps.geometry(n, deci, tile_rows)
        for p in (xr, xi):
            if tuple(p.shape) != (geo.total,):
                raise ValueError(f"packed plane shape {tuple(p.shape)} != "
                                 f"{(geo.total,)} for n={n}, deci={deci}, "
                                 f"tile_rows={geo.tile_rows}")
        pr, pi, m, shift = xr, xi, geo.m, geo.wlen - ntaps
    audio, _ = fm_chain_span(pr, pi, taps, deci, gain, first=0, count=m,
                             shift=shift, precision=precision, offset=offset)
    return audio[1:]


def fm_chain_window(xpr, xpi, taps, deci: int, gain: float = 1.0, *,
                    row0: int, g: int, tile_rows: int = 1024,
                    precision: str = "w3", offset: float = 0.0, seed=None):
    """The chain over a WINDOW of resident packed planes
    (``pallas_fm_chain_window``): output rows [row0, row0 + g*tile_rows)
    of 128 outputs each, read in place at the offset.

    Element j of the returned audio is demod(y[row0*128 + j - 1],
    y[row0*128 + j]), the j = 0 pair's left side taken from ``seed`` (the
    previous window's ``last``, so windows compose into one stream; at
    stream start the zero seed makes element 0 meaningless).  Returns
    ``(audio, last)`` with ``last`` this window's final filtered sample.
    """
    taps = tapset(taps)
    wlen = fir_window(len(taps), deci)
    tile_rows = taps.geometry(0, deci, tile_rows).tile_rows
    first, count = row0 * 128, g * tile_rows * 128
    if row0 < 0 or (first + count - 1) * deci + wlen > xpr.shape[0]:
        raise ValueError(f"window rows [{row0}, {row0 + g * tile_rows}) lie "
                         f"outside the packed planes ({xpr.shape[0]} samples)")
    return fm_chain_span(xpr, xpi, taps, deci, gain, first=first, count=count,
                         shift=wlen - len(taps), precision=precision,
                         offset=offset, seed=seed)


# ------------------------------------------- kernel C: quad_demod_fast

def _check_quad(x: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype != torch.complex64:
        raise ValueError(f"quad_demod_fast needs a 1-D complex64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quad_demod_fast needs a contiguous tensor")


def quad_demod_fast_plain(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`quad_demod_fast` (any device): the
    same order of operations on explicit I/Q planes."""
    _check_quad(x)
    v = torch.view_as_real(x)
    re, im = v[:, 0], v[:, 1]
    return demod_pairs(re[:-1], im[:-1], re[1:], im[1:], gain)


def quad_demod_fast(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """``out[k] = gain * fast_atan2(conj(x[k]) * x[k+1])`` for k < n - 1,
    f32 (the polynomial atan2, |err| < 1e-4 rad; the JAX package's
    ``pallas_quad_demod``).  Kernel C on CUDA tensors; the plain version
    on CPU tensors."""
    _check_quad(x)
    n = x.shape[0]
    if not _route(x):
        _worked(quad_work(n))
        return quad_demod_fast_plain(x, gain)
    out = torch.empty(max(n - 1, 0), dtype=torch.float32, device=x.device)
    if n < 2:
        return out
    planes = torch.view_as_real(x)
    if planes.data_ptr() % 8:
        raise ValueError("quad_demod_fast needs an 8-byte aligned tensor")
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_quad_demod(planes.data_ptr(), n, float(gain),
                                     out.data_ptr(), _stream(x.device)),
                   "quad_demod")
    _launched("quad_demod", None, quad_work(n))
    return out


# ------------------------------------ kernels D and E: clock recovery

MAX_CLOCK_TAPS = 16  # the kernels' bound on the clock filter (sync_core.cuh)


class SyncConsts(typing.NamedTuple):
    """The recurrences' f32 constants, as the JAX package computes them
    (symbol_sync.py:53-57, :107, :217-223); Python floats holding f32
    values, so a tensor op with them rounds as an f32 op."""
    sps: float
    mx: float
    mi08: float   # mi * 0.8, the TED's lower bound
    mx12: float   # mx * 1.2
    lo: float     # the clock filter's clamp, mi - sps ..
    hi: float     # .. mx - sps
    taps: tuple   # clock filter taps, f32 values
    nf: int       # filter history per channel, max(ntaps - 1, 1)


def sync_consts(sps: float, max_deviation: float, clock_taps) -> SyncConsts:
    taps = np.asarray(clock_taps, np.float32).reshape(-1)
    if not 1 <= len(taps) <= MAX_CLOCK_TAPS:
        raise ValueError(f"the clock filter takes 1..{MAX_CLOCK_TAPS} taps, "
                         f"got {len(taps)}")
    f = np.float32
    s, d = f(sps), f(max_deviation)
    mi, mx = f(s - d), f(s + d)
    return SyncConsts(float(s), float(mx), float(f(mi * f(0.8))),
                      float(f(mx * f(1.2))), float(f(mi - s)), float(f(mx - s)),
                      tuple(float(t) for t in taps), max(len(taps) - 1, 1))


def _clock_filter(k: SyncConsts, fbuf: list, sample):
    """(clamped output, shifted history) of the clock filter: taps[0] *
    sample + sum_j taps[j+1] * fbuf[j] in that order (symbol_sync.py:79-81),
    the history newest first."""
    ret = k.taps[0] * sample
    for j in range(len(k.taps) - 1):
        ret = ret + k.taps[j + 1] * fbuf[j]
    ret = torch.clamp(ret, k.lo, k.hi)
    if len(k.taps) > 1:
        return ret, [ret] + fbuf[:-1]
    return ret, fbuf


def ted_reduce(t0_raw, clock, mx: float):
    """``_ted_reduce`` (symbol_sync.py:149-167): the closed-form
    pre-reduction, then six predicated steps of the reference's while loop
    (the f32 sequence of the JAX form).  A step that changes no element
    ends the loop: the steps after it would change none either."""
    k0 = torch.clamp(torch.floor((t0_raw - mx) / clock) - 1.0, min=0.0)
    t = t0_raw - k0 * clock
    for _ in range(6):
        t2 = t - clock
        step = (t > mx) & (torch.abs(t - clock) >= torch.abs(t2 - clock))
        if not bool(step.any()):
            break
        t = torch.where(step, t2, t)
    return t


def _check_sync(x: torch.Tensor, dtype, state: torch.Tensor, width: int,
                what: str) -> None:
    if x.dim() != 2 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (C, N) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if (state.dtype != torch.float32 or tuple(state.shape) != (x.shape[0], width)
            or state.device != x.device):
        raise ValueError(f"{what} needs a ({x.shape[0]}, {width}) float32 "
                         f"state on {x.device}, got {tuple(state.shape)} "
                         f"{state.dtype} on {state.device}")


def symbol_sync_scan_plain(x: torch.Tensor, sps: float, max_deviation: float,
                           clock_taps, state: torch.Tensor):
    """Plain PyTorch version of :func:`symbol_sync_scan` (any device): a
    Python loop over the samples on (C,) tensors, the inner while loops
    run as predicated loops until no channel iterates."""
    k = sync_consts(sps, max_deviation, clock_taps)
    _check_sync(x, torch.float32, state, 5 + k.nf, "symbol_sync_scan")
    clock, sign_f, pos, last_b, next_mid = state.unbind(1)[:5]
    last_sign = sign_f != 0
    fbuf = list(state.unbind(1)[5:])
    masks, clks = [], []
    for sample in x.unbind(1):
        emit = pos >= next_mid
        masks.append(emit)
        clks.append(clock)
        next_mid = torch.where(emit, next_mid + clock, next_mid)
        sign = sample > 0.0
        changed = sign != last_sign
        adjust = changed & (pos > 0.0) & (last_b > 0.0)
        if bool(adjust.any()):
            # while t > mx { t2 = t - clock; if |t-clock| < |t2-clock| break;
            # t = t2 }
            t = pos - last_b
            while True:
                t2 = t - clock
                step = adjust & (t > k.mx) & ~(
                    torch.abs(t - clock) < torch.abs(t2 - clock))
                if not bool(step.any()):
                    break
                t = torch.where(step, t2, t)
            apply = adjust & (t > k.mi08) & (t < k.mx12)
            ret, fbuf2 = _clock_filter(k, fbuf, t - k.sps)
            new_clock = ret + k.sps
            # next_mid = last_boundary + clock/2, bumped up to stream_pos
            nm = last_b + new_clock / 2.0
            while True:
                step = apply & (nm < pos)
                if not bool(step.any()):
                    break
                nm = torch.where(step, nm + new_clock, nm)
            clock = torch.where(apply, new_clock, clock)
            next_mid = torch.where(apply, nm, next_mid)
            fbuf = [torch.where(apply, a, b) for a, b in zip(fbuf2, fbuf)]
        last_b = torch.where(changed, pos, last_b)
        last_sign = torch.where(changed, sign, last_sign)
        pos = pos + 1.0
        # step back to stay near zero (src/symbol_sync.rs:200-209)
        sb = 10.0 * clock
        back = (pos > sb) & (last_b > sb) & (next_mid > sb)
        if bool(back.any()):
            pos = torch.where(back, pos - sb, pos)
            last_b = torch.where(back, last_b - sb, last_b)
            next_mid = torch.where(back, next_mid - sb, next_mid)
    c, n = x.shape
    if n:
        mask, clocks = torch.stack(masks, 1), torch.stack(clks, 1)
    else:
        mask = torch.zeros((c, 0), dtype=torch.bool, device=x.device)
        clocks = torch.zeros((c, 0), dtype=torch.float32, device=x.device)
    out = torch.stack([clock, last_sign.float(), pos, last_b, next_mid, *fbuf], 1)
    return mask, clocks, out


def symbol_sync_scan(x: torch.Tensor, sps: float, max_deviation: float,
                     clock_taps, state: torch.Tensor):
    """The per-sample clock recovery of every channel of ``x`` (C, N),
    from ``state`` (C, 5 + nf) f32 rows ``[clock, last_sign, stream_pos,
    last_boundary, next_mid, fbuf...]`` (nf = max(ntaps - 1, 1); native
    ``rr_symbol_sync``'s layout).

    Returns ``(mask, clocks, new_state)``: ``mask`` (C, N) bool marks the
    emitted samples, ``clocks`` (C, N) f32 the clock at each sample before
    its step.  Kernel E on CUDA tensors; the plain version on CPU
    tensors."""
    k = sync_consts(sps, max_deviation, clock_taps)
    _check_sync(x, torch.float32, state, 5 + k.nf, "symbol_sync_scan")
    # from the shapes: the most the call could need, every sample a crossing
    work = scan_work(x.numel(), k.sps, x.numel(), len(k.taps) - 1)
    if not _route(x):
        _worked(work)
        return symbol_sync_scan_plain(x, sps, max_deviation, clock_taps, state)
    c, n = x.shape
    mask = torch.empty((c, n), dtype=torch.bool, device=x.device)
    clocks = torch.empty((c, n), dtype=torch.float32, device=x.device)
    out = state.clone()
    if c == 0 or n == 0:
        return mask, clocks, out
    taps = np.asarray(k.taps, np.float32)
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_symbol_sync_scan(
        x.data_ptr(), c, n, k.sps, float(np.float32(max_deviation)),
        taps.ctypes.data, len(taps), out.data_ptr(), out.shape[1],
        mask.data_ptr(), clocks.data_ptr(), _stream(x.device)),
        "symbol_sync_scan")
    _launched("symbol_sync_scan", None, work)
    return mask, clocks, out


def _check_events(events: torch.Tensor, n: int, fstate: torch.Tensor,
                  istate: torch.Tensor, k: SyncConsts,
                  counts: torch.Tensor | None) -> None:
    _check_sync(events, torch.int32, fstate, 3 + k.nf, "symbol_sync_events_scan")
    if (istate.dtype != torch.int32 or tuple(istate.shape) != (events.shape[0], 3)
            or istate.device != events.device):
        raise ValueError(f"symbol_sync_events_scan needs a ({events.shape[0]}, "
                         f"3) int32 istate on {events.device}")
    if not 0 <= n < 1 << 24:
        raise ValueError(f"n={n}: positions stay f32-exact only below 2^24")
    if counts is not None and (
            counts.dtype != torch.int32 or tuple(counts.shape) != events.shape[:1]
            or counts.device != events.device or not counts.is_contiguous()):
        raise ValueError(f"symbol_sync_events_scan needs ({events.shape[0]},) "
                         f"int32 counts on {events.device}")


def symbol_sync_events_scan_plain(events: torch.Tensor, n: int, sps: float,
                                  max_deviation: float, clock_taps,
                                  fstate: torch.Tensor, istate: torch.Tensor,
                                  counts: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`symbol_sync_events_scan` (any
    device): a Python loop over the slots on (C,) tensors, up to the last
    slot that holds a crossing on any channel (padding slots after it
    change no state).  It finds the padding itself, whether or not
    ``counts`` is given."""
    k = sync_consts(sps, max_deviation, clock_taps)
    _check_events(events, n, fstate, istate, k, counts)
    clock, mid_off, bnd_off = fstate.unbind(1)[:3]
    fbuf = list(fstate.unbind(1)[3:])
    p_prev, have_b, started = istate.unbind(1)
    have_b, started = have_b != 0, started != 0
    c, n_ev = events.shape
    last = int((events < n).sum(1).max()) if c and n_ev else 0
    mids, clks = [], []
    for p in events[:, :last].unbind(1):
        is_pad = p >= n
        gap_i = p - p_prev
        gap = gap_i.float()
        # emissions in (p_prev, p] bump mid before the crossing adjusts it
        e_unc = torch.floor((gap - mid_off) / clock).to(torch.int32) + 1
        e = torch.minimum(torch.clamp(e_unc, min=0), gap_i)
        mid_off_p = mid_off + e.float() * clock - gap
        t0_raw = gap + bnd_off
        t = ted_reduce(t0_raw, clock, k.mx)
        past_start = started | (p > 0)
        apply = past_start & have_b & (t > k.mi08) & (t < k.mx12) & ~is_pad
        ret, fbuf2 = _clock_filter(k, fbuf, t - k.sps)
        new_clock = ret + k.sps
        # next_sym_middle = last_boundary + clock/2 bumped to >= p, in
        # closed form from the raw boundary offset
        nm0 = new_clock / 2.0 - t0_raw
        kk = torch.clamp(torch.ceil(-nm0 / new_clock), min=0.0)
        nm = torch.clamp(nm0 + kk * new_clock, min=0.0)
        clock = torch.where(apply, new_clock, clock)
        fbuf = [torch.where(apply, a, b) for a, b in zip(fbuf2, fbuf)]
        mid_off = torch.where(is_pad, mid_off, torch.where(apply, nm, mid_off_p))
        p_prev = torch.where(is_pad, p_prev, p)
        bnd_off = torch.where(is_pad, bnd_off, 0.0)
        have_b = torch.where(is_pad, have_b, past_start)
        mids.append(mid_off)
        clks.append(clock)
    def rows(per_slot: list, final: torch.Tensor) -> torch.Tensor:
        # the padding tail holds the final state
        col = final[:, None]
        return torch.cat([torch.stack(per_slot, 1) if per_slot else col[:, :0],
                          col.expand(c, n_ev - last)], 1)

    ev_mid, ev_clock = rows(mids, mid_off), rows(clks, clock)
    fout = torch.stack([clock, mid_off, bnd_off, *fbuf], 1)
    iout = torch.stack([p_prev, have_b.to(torch.int32), started.to(torch.int32)], 1)
    return ev_mid, ev_clock, fout, iout


def symbol_sync_events_scan(events: torch.Tensor, n: int, sps: float,
                            max_deviation: float, clock_taps,
                            fstate: torch.Tensor, istate: torch.Tensor,
                            counts: torch.Tensor | None = None):
    """The event step of ``symbol_sync_events`` over each channel's slots.

    ``events`` (C, E) int32: each channel's crossing positions in a stream
    of ``n`` samples, ascending, padded with ``n``.  ``fstate`` (C, 3 + nf)
    f32 rows ``[clock, mid_off, bnd_off, fbuf...]`` and ``istate`` (C, 3)
    int32 rows ``[p_prev, have_boundary, started]`` are the carried state.
    Returns ``(ev_mid, ev_clock, fstate_out, istate_out)``, ``ev_mid`` and
    ``ev_clock`` (C, E) f32 the mid offset and clock after each slot.
    ``counts`` (C,) int32, where the caller has it, is each channel's
    number of crossing slots (the slots before its padding); the kernel
    then looks for no padding.  Kernel D on CUDA tensors; the plain version
    on CPU tensors."""
    k = sync_consts(sps, max_deviation, clock_taps)
    _check_events(events, n, fstate, istate, k, counts)
    # from the shapes: the most the call could need, every slot real
    work = events_work(events.numel(), events.numel(), len(k.taps) - 1)
    if not _route(events):
        _worked(work)
        return symbol_sync_events_scan_plain(events, n, sps, max_deviation,
                                             clock_taps, fstate, istate, counts)
    c, n_ev = events.shape
    ev_mid = torch.empty((c, n_ev), dtype=torch.float32, device=events.device)
    ev_clock = torch.empty_like(ev_mid)
    fout, iout = fstate.clone(), istate.clone()
    if c == 0:
        return ev_mid, ev_clock, fout, iout
    taps = np.asarray(k.taps, np.float32)
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_symbol_sync_events(
        events.data_ptr(), None if counts is None else counts.data_ptr(),
        c, n_ev, n, k.sps, float(np.float32(max_deviation)),
        taps.ctypes.data, len(taps), fout.data_ptr(), fout.shape[1],
        iout.data_ptr(), ev_mid.data_ptr(), ev_clock.data_ptr(),
        _stream(events.device)), "symbol_sync_events")
    _launched("symbol_sync_events", None, work)
    return ev_mid, ev_clock, fout, iout


# ------------------------------------- kernels F and G: the recurrences

MAX_CMA_TAPS = 128   # kernel F's bound (csrc/cma.cu, four taps a lane)
CMA_BLOCK = 32       # kernel F's block of windows (csrc/cma.cu, kBlock)
MAX_IIR_ORDER = 32   # kernel G's bound (csrc/iir.cu)
# kernel G's layout (csrc/iir.cu, kChunk, kBlock, kLevels): samples a
# chunk, chunks a block, and the powers M^(2^j) of M = A^IIR_CHUNK it reads
IIR_CHUNK = 128
IIR_BLOCK = 128
_IIR_LOG_BLOCK = IIR_BLOCK.bit_length() - 1
IIR_LEVELS = 2 * _IIR_LOG_BLOCK + 1


def cma_work(n: int, ntaps: int):
    """Kernel F: n complex64 in, n - ntaps + 1 out, the taps in and out; a
    window's 16 * ntaps + 4 f32 operations (the products, their sum, e, the
    update)."""
    nwin = max(n - ntaps + 1, 0)
    return (float(8 * (n + nwin) + 16 * ntaps),
            float(nwin * (16 * ntaps + 4)))


def iir_work(n: int, order: int):
    """Kernel G: n f32 in and out, the history in; 2 * order + 1 f32
    operations a sample (the recurrence's own; the chunked scan's matrix
    products, and their scaling for a growing filter, are the design's)."""
    return float(8 * n + 4 * order), float(n * (2 * order + 1))


def cma_chain_links(nwin: int, ntaps: int) -> tuple[int, int]:
    """(f32 links, shuffle-add links) of the longest dependent chain in
    kernel F's call on nwin windows (csrc/cma.cu), blocks of ``CMA_BLOCK``
    windows.  Every window's c goes to every lane by a shuffle, whose
    first dependent operation (a multiplication) makes a shuffle-add link.
    A window takes its partial as y (|y|^2 2 links, e 1, mu * e 1, c 1);
    a block's later windows first add the newest term (the product's
    subtraction 1 after its shuffle-add link, the addition 1); after a
    block's last window the taps' update (2 after its shuffle-add link),
    and before every block its bases (the product 2, the lane sums one a
    slot of 32 taps, the fold 5).  The shared-memory store and load of the
    taps between the update and the bases are not counted."""
    blocks = -(-nwin // CMA_BLOCK)
    bases = 7 + -(-ntaps // 32)
    links = 5 * nwin + 2 * (nwin - blocks) + 2 * blocks + bases * blocks
    return links, nwin


def iir_chain_links(n: int, taps) -> int:
    """The longest chain of dependent f32 operations in kernel G's call on
    n samples of the filter ``taps`` (csrc/iir.cu): the walks (two links a
    sample, as the most recent term is added last), and where there is
    more than one chunk the first walk, a block's scan (seven levels of a
    row sum, order links, and the addition into the state) and the powers
    applied to a carry (at most seven matrix rows); where there is more
    than one block, the carries' scan over its tiles (seven levels and
    eight powers a tile).  A filter whose powers carry an exponent
    (:func:`iir_exponents` not all 0: a growing filter) scales every row
    sum of a product, one link more a row."""
    taps = np.ascontiguousarray(taps, np.float32).reshape(-1)
    chunks = -(-n // IIR_CHUNK)
    blocks = -(-chunks // IIR_BLOCK)
    # a product's row: its sum over the order's columns, then its scaling
    row = len(taps) - 1 + int(iir_exponents(taps).any())
    links = 2 * IIR_CHUNK
    if chunks > 1:
        links += 2 * IIR_CHUNK + 2 * 7 * (row + 1)
    if blocks > 1:
        links += -(-(blocks - 1) // IIR_BLOCK) * (7 * (row + 1) + 8 * row + 1)
    return links


def _f32(v: float) -> float:
    """A Python float holding the f32 value of ``v`` (what the kernels
    receive), so that a tensor op with it rounds as an f32 op."""
    return float(np.float32(v))


def _check_cma(x: torch.Tensor, taps: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype != torch.complex64 or not x.is_contiguous():
        raise ValueError(f"cma_scan needs a contiguous 1-D complex64 stream, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if (taps.dim() != 1 or taps.dtype != torch.complex64
            or taps.device != x.device):
        raise ValueError(f"cma_scan needs 1-D complex64 taps on {x.device}, "
                         f"got {tuple(taps.shape)} {taps.dtype} on {taps.device}")
    if not 1 <= taps.shape[0] <= MAX_CMA_TAPS:
        raise ValueError(f"cma_scan takes 1..{MAX_CMA_TAPS} taps, "
                         f"got {taps.shape[0]}")
    if x.shape[0] < taps.shape[0]:
        raise ValueError(f"input {x.shape[0]} shorter than taps {taps.shape[0]}")


def _cma_bases(t: torch.Tensor, wins: torch.Tensor, slots: int) -> torch.Tensor:
    """(2, rows): the taps ``t`` (2, width; zero past the last tap) against
    ``wins`` (rows, 2, width; zero past the last tap) in kernel F's order:
    32 lane sums, lane l from +0.0 over taps l, l + 32, ... (a slot past the
    last tap adds the +0.0 product of a zero tap and a zero sample, which
    leaves the sum as it is), then the lanes folded in halves (16, 8, 4, 2,
    1)."""
    tr, ti = t[0], t[1]
    wr, wi = wins[:, 0], wins[:, 1]
    p = torch.stack([tr * wr - ti * wi, tr * wi + ti * wr])
    p = p.view(2, wins.shape[0], slots, 32)
    acc = p[:, :, 0] + 0.0
    for j in range(1, slots):
        acc = acc + p[:, :, j]
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half : 2 * half]
    return acc[..., 0]


def _cma_lags(xv: torch.Tensor, nblocks: int, ntaps: int) -> torch.Tensor:
    """(2, nblocks, K, K), K = ``CMA_BLOCK``: entry [:, b, m, j] = sum over
    k < ntaps of conj(x[bK + m + k]) x[bK + j + k], from k = 0 up, each
    product conj(a) b = (ar br + ai bi, ar bi - ai br); x zero past its
    end.  Kernel F computes and reads the entries with m < j."""
    k_ = CMA_BLOCK
    span = (nblocks + 1) * k_ + ntaps
    xp = F.pad(xv.t(), (0, span - xv.shape[0]))  # (2, span)
    acc = None
    for k in range(ntaps):
        seg = xp[:, k : k + nblocks * k_].reshape(2, nblocks, k_)
        ar, ai = seg[0].unsqueeze(2), seg[1].unsqueeze(2)  # row m
        br, bi = seg[0].unsqueeze(1), seg[1].unsqueeze(1)  # column j
        c = torch.stack([ar * br + ai * bi, ar * bi - ai * br])
        acc = c if acc is None else acc + c
    return acc


def cma_scan_plain(x: torch.Tensor, taps: torch.Tensor,
                   desired_modulus: float, step_size: float):
    """Plain PyTorch version of :func:`cma_scan` (any device), in kernel F's
    order: the windows in blocks of ``CMA_BLOCK`` counted from the call's
    start.  For the block from window B, with the taps t_B that the windows
    before it left:

    1. the bases a_n = t_B . w_n of its windows (:func:`_cma_bases`);
    2. the lag sums G[m, n] = conj(w_m) . w_n, m < n in the block
       (:func:`_cma_lags`, every block at once: they read x alone);
    3. the walk: y_n = a_n + c_B G[B, n] + ... + c_{n-1} G[n-1, n], the
       terms added from the oldest up, each c_m G[m, n] = (cr Gr - ci Gi,
       cr Gi + ci Gr); e = R - (yr^2 + yi^2), c_n = (mu * e) * y_n;
    4. the taps, updated after each window as the sequential recurrence
       updates them: t += (cr wr + ci wi, ci wr - cr wi).

    In exact arithmetic y_n = t_n . w_n, t_n = t_B + sum_{m<n} c_m conj(w_m):
    the sequential recurrence's function, rounded in another order."""
    _check_cma(x, taps)
    r, mu = _f32(desired_modulus), _f32(step_size)
    ntaps = taps.shape[0]
    nwin = x.shape[0] - ntaps + 1
    slots = -(-ntaps // 32)
    width = 32 * slots
    xv = torch.view_as_real(x)
    # windows of width samples, zeroed past the last tap: (nwin, 2, width)
    xp = F.pad(xv.t(), (0, width - ntaps))
    wins = xp.unfold(1, width, 1)[:, :nwin].permute(1, 0, 2)
    live = torch.arange(width, device=x.device) < ntaps
    wins = torch.where(live, wins, torch.zeros((), device=x.device))
    t = F.pad(torch.view_as_real(taps).t(), (0, width - ntaps))  # (2, width)
    nblocks = -(-nwin // CMA_BLOCK)
    lags = _cma_lags(xv, nblocks, ntaps)
    y = torch.empty((2, nwin), dtype=torch.float32, device=x.device)
    for b in range(nblocks):
        n0 = b * CMA_BLOCK
        cnt = min(CMA_BLOCK, nwin - n0)
        p = _cma_bases(t, wins[n0 : n0 + cnt], slots)  # (2, cnt)
        for i in range(cnt):
            yv = p[:, i]
            sq = yv * yv
            c = (mu * (r - (sq[0] + sq[1]))) * yv  # (cr, ci)
            if i + 1 < cnt:
                gm = lags[:, b, i, i + 1 : cnt]  # (Gr, Gi) to the later windows
                a = c.view(2, 1) * gm            # (cr Gr, ci Gi)
                d = c.view(2, 1) * gm.flip(0)    # (cr Gi, ci Gr)
                p[:, i + 1 :] = p[:, i + 1 :] + torch.stack([a[0] - a[1], d[0] + d[1]])
            w = wins[n0 + i]
            a = c.view(2, 1) * w                 # (cr wr, ci wi)
            d = c.flip(0).view(2, 1) * w         # (ci wr, cr wi)
            t = t + torch.stack([a[0] + a[1], d[0] - d[1]])
            y[:, n0 + i] = yv
    final = torch.complex(t[0, :ntaps], t[1, :ntaps])
    return torch.view_as_complex(y.t().contiguous()), final


def cma_scan(x: torch.Tensor, taps: torch.Tensor, desired_modulus: float,
             step_size: float):
    """The CMA recurrence over ``x`` (1-D complex64) from ``taps`` (1-D
    complex64 on its device, 1..``MAX_CMA_TAPS``): for each window w =
    x[i : i + ntaps], y = sum(taps * w), e = R - |y|^2, taps += ((mu * e)
    * y) * conj(w).  Returns ``(y, final_taps)``, y of n - ntaps + 1
    samples.  Every product and sum rounded in f32 in a fixed order, the
    delayed-update form over blocks of ``CMA_BLOCK`` windows from the
    call's start (:func:`cma_scan_plain`): a call split after a multiple
    of ``CMA_BLOCK`` windows, the taps carried, gives the same bits, one
    split elsewhere the same values within rounding.  Kernel F (one
    launch) on CUDA tensors; the plain version on CPU tensors."""
    _check_cma(x, taps)
    work = cma_work(x.shape[0], taps.shape[0])
    if not _route(x):
        _worked(work)
        return cma_scan_plain(x, taps, desired_modulus, step_size)
    nwin = x.shape[0] - taps.shape[0] + 1
    y = torch.empty(nwin, dtype=torch.complex64, device=x.device)
    final = taps.clone()
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_cma_equalize(
        x.data_ptr(), x.shape[0], taps.shape[0], _f32(desired_modulus),
        _f32(step_size), final.data_ptr(), y.data_ptr(), _stream(x.device)),
        "cma_equalize")
    _launched("cma", None, work)
    return y, final


def _check_iir(x: torch.Tensor, taps: np.ndarray, history: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"iir_scan needs a contiguous 1-D float32 stream, "
                         f"got {tuple(x.shape)} {x.dtype}")
    order = len(taps) - 1
    if not 1 <= order <= MAX_IIR_ORDER:
        raise ValueError(f"iir_scan takes orders 1..{MAX_IIR_ORDER}, got {order}")
    if (tuple(history.shape) != (order,) or history.dtype != torch.float32
            or history.device != x.device):
        raise ValueError(f"iir_scan needs a ({order},) float32 history on "
                         f"{x.device}, got {tuple(history.shape)} "
                         f"{history.dtype} on {history.device}")


# past this exponent every nonzero f32 times 2^e overflows (2^-149 2^278 =
# 2^129): products are scaled by 2^min(e, IIR_EXP_CAP), the same values
IIR_EXP_CAP = 300


def _iir_level(m: np.ndarray, e: int) -> tuple[np.ndarray, int]:
    """(f32 level, exponent s) of the float64 power m * 2^e, level * 2^s
    that power: s = 0 where it rounds to a finite f32 (each entry rounded
    once, as m * 2^e itself), else the smallest s that makes it finite."""
    if not np.isfinite(m).all():  # NaN or inf taps
        return m.astype(np.float32), 0
    big = float(np.abs(m).max())
    s = max(0, int(np.frexp(big)[1]) + e - 128) if big else 0
    while True:
        with np.errstate(over="ignore"):
            out = np.ldexp(m, e - s).astype(np.float32)
        if np.isfinite(out).all():
            return out, s
        s += 1


@functools.lru_cache(maxsize=64)
def _iir_powers(taps_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
    taps = np.frombuffer(taps_bytes, np.float32).astype(np.float64)
    p = len(taps) - 1
    a = np.zeros((p, p))
    a[0] = taps[1:]
    a[np.arange(1, p), np.arange(p - 1)] = 1.0
    levels = np.empty((IIR_LEVELS, p, p), np.float32)
    exps = np.zeros(IIR_LEVELS, np.int32)
    first = IIR_CHUNK.bit_length() - 1  # M = A^IIR_CHUNK
    m, e = a, 0  # the power A^(2^i) is m * 2^e
    for i in range(first + IIR_LEVELS):
        if i >= first:
            levels[i - first], exps[i - first] = _iir_level(m, e)
        m, e = m @ m, 2 * e
        big = np.abs(m).max()
        # past 2^500 (the next squaring would overflow float64) and from
        # then on, m is kept at a largest entry in [0.5, 1)
        if big > 2.0 ** 500 or (e and big):
            k = int(np.frexp(big)[1])
            m, e = np.ldexp(m, -k), e + k
    levels.setflags(write=False)
    exps.setflags(write=False)
    return levels, exps


def iir_powers(taps) -> np.ndarray:
    """Kernel G's powers: (IIR_LEVELS, p, p) f32, level j with M^(2^j) =
    level j * 2^(:func:`iir_exponents` j), M = A^IIR_CHUNK, A the companion
    matrix of the order-p filter ``taps`` (state most recent output first:
    A[0] = taps[1:], ones below the diagonal).  Squared in float64 from the
    f32 taps, carried as a float64 matrix and a power-of-two exponent where
    float64 itself would overflow; a level that rounds to a finite f32 is
    that rounding (exponent 0: every stable filter), else it is scaled by
    the smallest power of two that makes it finite.  Cached per taps
    (read-only)."""
    return _iir_powers(np.ascontiguousarray(taps, np.float32).tobytes())[0]


def iir_exponents(taps) -> np.ndarray:
    """The (IIR_LEVELS,) int32 power-of-two exponents of
    :func:`iir_powers`' levels: 0 wherever M^(2^j) is a finite f32."""
    return _iir_powers(np.ascontiguousarray(taps, np.float32).tobytes())[1]


@functools.lru_cache(maxsize=64)
def _iir_powers_on(taps_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_iir_powers(taps_bytes)[0].copy()).to(device)


def _iir_layout(n: int) -> tuple[int, int]:
    """(chunks, blocks) of an n-sample call."""
    chunks = -(-n // IIR_CHUNK)
    return chunks, -(-chunks // IIR_BLOCK)


def _iir_walk(tx: torch.Tensor, t: list, h: list, out: bool):
    """Every chunk's walk at once: ``tx`` (chunks, IIR_CHUNK) holds taps[0]
    * x, ``h`` the p states (chunks,), most recent first.  Returns the end
    states and, with ``out``, the outputs (chunks, IIR_CHUNK)."""
    p = len(t) - 1
    ys = []
    for j in range(tx.shape[1]):
        acc = tx[:, j]
        for i in range(p, 1, -1):
            acc = acc + t[i] * h[i - 1]
        y = acc + t[1] * h[0]
        h = [y] + h[:-1]
        if out:
            ys.append(y)
    return h, (torch.stack(ys, 1) if out else None)


def _iir_matvec(m: torch.Tensor, v: torch.Tensor, shift: int) -> torch.Tensor:
    """m (p, p) times the columns of v (p, N), each row summed from column 0
    up, every product and sum an f32 op of its own, then the sums times
    2^shift (ldexpf's value: exact, inf only past f32's largest; a zero
    stays zero)."""
    acc = m[:, :1] * v[:1]
    for c in range(1, m.shape[0]):
        acc = acc + m[:, c : c + 1] * v[c : c + 1]
    shift = min(shift, IIR_EXP_CAP)
    while shift > 0:  # powers of two of at most 2^126, each exact in f32
        k = min(shift, 126)
        acc, shift = acc * float(2 ** k), shift - k
    return acc


def _iir_scan_blocks(u: torch.Tensor, pw: torch.Tensor, ex) -> torch.Tensor:
    """Hillis-Steele over the last axis of u (p, blocks, IIR_BLOCK), each
    block alone: level j adds pw[j] 2^ex[j] u[i - 2^j] where i >= 2^j."""
    p, nb, b = u.shape
    for j in range(_IIR_LOG_BLOCK):
        d = 1 << j
        add = _iir_matvec(pw[j], u[:, :, : b - d].reshape(p, -1), ex[j])
        u = torch.cat([u[:, :, :d], u[:, :, d:] + add.view(p, nb, b - d)], 2)
    return u


def _iir_power(v: torch.Tensor, e: torch.Tensor, pw: torch.Tensor, ex,
               nbits: int) -> torch.Tensor:
    """Each column v[:, i] times pw[j] 2^ex[j] for the set bits j of e[i],
    lowest first."""
    for j in range(nbits):
        v = torch.where(((e >> j) & 1).bool(), _iir_matvec(pw[j], v, ex[j]), v)
    return v


def iir_scan_plain(x: torch.Tensor, taps, history: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`iir_scan` (any device), kernel G's
    arithmetic in its order: the stream in chunks of ``IIR_CHUNK`` samples
    (zeros past n), blocks of ``IIR_BLOCK`` chunks.

    1. Every chunk walks from a zero state (chunk 0 from ``history``): a
       Python loop over a chunk's positions, vectorised over the chunks;
       each step taps[0] * x[n], then the terms from the oldest output down
       to taps[2] * y[n - 2], then taps[1] * y[n - 1] last.  Each block
       scans its end states (:func:`_iir_scan_blocks`, powers 0..6).
    2. The blocks' last states, but the last block's, are scanned the same
       way in tiles of IIR_BLOCK (powers 7..13), tile by tile, each tile's
       carry from the one before applied to its i-th entry as
       (M^IIR_BLOCK)^(i + 1) (:func:`_iir_power`, powers 7..14).
    3. Each chunk's starting state: the history (chunk 0); its
       predecessor's end (block 0); the carry into its block (a block's
       first chunk); else its predecessor's end plus M^i times the carry;
       then every chunk walks again from it.

    Every matrix product is :func:`_iir_matvec`, with the f32 powers of
    :func:`iir_powers` and their exponents (:func:`iir_exponents`): a
    product's sums are scaled by 2^exponent, so a zero state stays zero
    and a tiny one gives a finite product wherever the true one is."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    _check_iir(x, taps, history)
    t = [float(v) for v in taps]
    p, n = len(t) - 1, x.shape[0]
    if n == 0:
        return x.new_zeros(0)
    chunks, blocks = _iir_layout(n)
    tx = F.pad(x * t[0], (0, chunks * IIR_CHUNK - n)).view(chunks, IIR_CHUNK)
    start = torch.zeros((p, chunks), dtype=torch.float32, device=x.device)
    start[:, 0] = history
    if chunks > 1:
        pw = _iir_powers_on(taps.tobytes(), x.device)
        ex = [int(v) for v in _iir_powers(taps.tobytes())[1]]
        width = blocks * IIR_BLOCK
        ends, _ = _iir_walk(tx, t, list(start.unbind(0)), False)
        u = F.pad(torch.stack(ends), (0, width - chunks))
        u = _iir_scan_blocks(u.view(p, blocks, IIR_BLOCK), pw, ex).reshape(p, width)
        carry = torch.zeros((p, blocks), dtype=torch.float32, device=x.device)
        q = blocks - 1
        if q:
            tiles = -(-q // IIR_BLOCK)
            last = F.pad(u[:, IIR_BLOCK - 1 :: IIR_BLOCK][:, :q],
                         (0, tiles * IIR_BLOCK - q))
            hi, hx = pw[_IIR_LOG_BLOCK:], ex[_IIR_LOG_BLOCK:]
            z = _iir_scan_blocks(last.view(p, tiles, IIR_BLOCK), hi, hx)
            e = torch.arange(1, IIR_BLOCK + 1, device=x.device)
            out = [z[:, 0]]
            for tile in range(1, tiles):
                c = out[-1][:, -1:].expand(p, IIR_BLOCK)
                out.append(z[:, tile] + _iir_power(c, e, hi, hx,
                                                   _IIR_LOG_BLOCK + 1))
            carry[:, 1:] = torch.cat(out, 1)[:, :q]
        k = torch.arange(1, chunks, device=x.device)
        i = k % IIR_BLOCK
        prev = u[:, :chunks - 1]
        c = carry[:, k // IIR_BLOCK]
        moved = prev + _iir_power(c, i, pw, ex, _IIR_LOG_BLOCK)
        start[:, 1:] = torch.where(k < IIR_BLOCK, prev,
                                   torch.where(i == 0, c, moved))
    _, y = _iir_walk(tx, t, list(start.unbind(0)), True)
    return y.reshape(-1)[:n]


def iir_scan(x: torch.Tensor, taps, history: torch.Tensor) -> torch.Tensor:
    """The reference's IIR recurrence over ``x`` (1-D f32), order
    len(taps) - 1 in 1..``MAX_IIR_ORDER``: y[n] = taps[0] * x[n] +
    sum_{i>=1} taps[i] * y[n - i], from ``history`` (order f32 on x's
    device, the last outputs, most recent first).  In chunks of
    ``IIR_CHUNK`` samples, their starting states from a fixed scan
    (:func:`iir_scan_plain`); the first chunk is the sequential form,
    summed in f32 from the oldest term down, taps[1] * y[n - 1] last.
    Kernel G on CUDA tensors (one to three launches: one for a single
    chunk, two for a single block); the plain version on CPU tensors."""
    taps = np.ascontiguousarray(taps, np.float32).reshape(-1)
    _check_iir(x, taps, history)
    n, p = x.shape[0], len(taps) - 1
    work = iir_work(n, p)
    if not _route(x):
        _worked(work)
        return iir_scan_plain(x, taps, history)
    y = torch.empty_like(x)
    if n == 0:
        return y
    _, blocks = _iir_layout(n)
    scratch = torch.empty(p * blocks * (IIR_BLOCK + 1), dtype=torch.float32,
                          device=x.device)
    pw = _iir_powers_on(taps.tobytes(), x.device)
    ex = _iir_powers(taps.tobytes())[1]
    hist = history.contiguous()
    lib = cuda_lib.load()
    cuda_lib.check(lib.rr_iir_filter(
        x.data_ptr(), n, taps.ctypes.data, len(taps), ex.ctypes.data,
        hist.data_ptr(), pw.data_ptr(), scratch.data_ptr(), y.data_ptr(),
        _stream(x.device)), "iir_filter")
    _launched("iir", None, work)
    return y
