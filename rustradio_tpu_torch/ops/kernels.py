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

``tools/csrc/symbol_sync_lone.cu`` keeps both as one thread per channel,
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
import typing

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_lib
from .demod import demod_pairs

LAUNCHES = {"fir_decimate": 0, "fm_chain": 0, "quad_demod": 0,
            "symbol_sync_events": 0, "symbol_sync_scan": 0}



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
