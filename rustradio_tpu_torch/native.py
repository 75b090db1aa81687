"""ctypes bindings for the host C++ of the AX.25 receive tail
(``native/rr_native.cpp``, shared with the JAX package).

The library is built by ``g++`` at first use, never at import, into
``rustradio_tpu_torch/_build/librr_native_<hash>.so`` (git-ignored;
:mod:`._buildcache`), so the JAX package's own ``native/librr_native.so``
is never touched.  The hash covers the source, the flags and the target
that ``g++`` resolves ``-march=native`` to on this host, so a build
directory carried to another CPU builds its own library there.  The flags
are the JAX package's (``rustradio_tpu/native.py``), so ``symbol_sync_f32``
is bit-identical to the one it calls.

Bound here: ``rr_symbol_sync`` (clock recovery, with its state carried in
and out), ``rr_zero_crossing`` (fixed-clock recovery, likewise) and
``rr_hdlc_*`` (the resumable HDLC deframer).
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np

from . import _buildcache

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR.parent / "native" / "rr_native.cpp"
BUILD_DIR = _buildcache.BUILD_DIR
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC")


def _cxx() -> str:
    return shutil.which("g++") or "g++"


@functools.lru_cache(maxsize=None)
def host_target() -> str:
    """The target options ``g++`` enables for CXX_FLAGS on this host
    (``-Q --help=target``): the resolved ``-march=native``; empty when
    ``g++`` cannot run (the build then raises)."""
    try:
        r = subprocess.run([_cxx(), *CXX_FLAGS, "-Q", "--help=target"],
                           capture_output=True, text=True)
    except OSError:
        return ""
    return r.stdout if r.returncode == 0 else ""


def library_path() -> Path:
    return _buildcache.hashed_path(
        BUILD_DIR, "librr_native",
        [" ".join(CXX_FLAGS), host_target(), SOURCE.read_bytes()])


def build() -> Path:
    """Compile rr_native.cpp unless a library of the same hash exists."""
    out = library_path()
    _buildcache.build(out, lambda tmp: [_cxx(), *CXX_FLAGS, "-o", str(tmp),
                                        str(SOURCE), "-lpthread"])
    return out


def _bind(lib):
    p, sz, i, f = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_float
    lib.rr_symbol_sync.restype = sz
    lib.rr_symbol_sync.argtypes = [p, sz, f, f, p, sz, p, p, p]
    lib.rr_zero_crossing.restype = sz
    lib.rr_zero_crossing.argtypes = [p, sz, f, p, p]
    lib.rr_hdlc_create.restype = p
    lib.rr_hdlc_create.argtypes = [i] * 4
    lib.rr_hdlc_destroy.argtypes = [p]
    lib.rr_hdlc_destroy.restype = None
    lib.rr_hdlc_feed.restype = sz
    lib.rr_hdlc_feed.argtypes = [p, p, sz]
    lib.rr_hdlc_pending_bytes.restype = sz
    lib.rr_hdlc_pending_bytes.argtypes = [p]
    lib.rr_hdlc_drain.restype = sz
    lib.rr_hdlc_drain.argtypes = [p, p, p, p, sz]
    lib.rr_hdlc_stats.argtypes = [p, ctypes.POINTER(ctypes.c_uint64)]
    lib.rr_hdlc_stats.restype = None
    return lib


_LIBRARY = _buildcache.Library(build, _bind)


def load():
    """The native library, built on first call; raises if it cannot be
    built (the failure is remembered, so later calls raise at once)."""
    return _LIBRARY.load()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32(v) -> np.float32:
    """A state value (Python or numpy scalar, 0-d array or tensor on any
    device) as an f32."""
    return np.float32(float(v))


def symbol_sync_f32_state(x: np.ndarray, sps: float, max_deviation: float,
                          clock_taps, state: dict | None = None):
    """Native symbol sync (``rr_symbol_sync``) from ``state`` (None: a fresh
    stream): the exact f32 recurrence of the JAX package's
    ``ops.symbol_sync``.  Returns ``(symbols, clocks, final_state)``, f32
    numpy arrays and a dict with the scan's keys (``clock``,
    ``last_sign``, ``stream_pos``, ``last_sym_boundary_pos``,
    ``next_sym_middle``, ``fbuf``), as ``rustradio_tpu/native.py:247``
    returns it, so a stream resumes across the two packages, the device
    forms and checkpoints."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    taps = np.ascontiguousarray(clock_taps, np.float32)
    nf = max(len(taps) - 1, 1)
    st = np.empty(5 + nf, np.float32)
    if state is None:
        sps32 = np.float32(sps)
        st[:5] = (sps32, 0.0, 0.0, 0.0, sps32 / np.float32(2.0))
        st[5:] = sps32
    else:
        st[0] = _f32(state["clock"])
        st[1] = 1.0 if bool(state["last_sign"]) else 0.0
        st[2] = _f32(state["stream_pos"])
        st[3] = _f32(state["last_sym_boundary_pos"])
        st[4] = _f32(state["next_sym_middle"])
        fbuf = state["fbuf"]
        if hasattr(fbuf, "detach"):
            fbuf = fbuf.detach().cpu().numpy()
        st[5:] = np.asarray(fbuf, np.float32).reshape(-1)
    vals = np.empty(len(x), np.float32)
    clks = np.empty(len(x), np.float32)
    k = lib.rr_symbol_sync(
        _ptr(x), len(x), ctypes.c_float(np.float32(sps)),
        ctypes.c_float(np.float32(max_deviation)), _ptr(taps), len(taps),
        _ptr(st), _ptr(vals), _ptr(clks))
    final = dict(
        clock=np.float32(st[0]), last_sign=bool(st[1] != 0.0),
        stream_pos=np.float32(st[2]), last_sym_boundary_pos=np.float32(st[3]),
        next_sym_middle=np.float32(st[4]), fbuf=st[5:].copy())
    return vals[:k].copy(), clks[:k].copy(), final


def symbol_sync_f32(x: np.ndarray, sps: float, max_deviation: float,
                    clock_taps, state: dict | None = None) -> np.ndarray:
    """The emitted symbols of :func:`symbol_sync_f32_state` alone, as an f32
    numpy array (from a fresh stream unless ``state`` is given)."""
    return symbol_sync_f32_state(x, sps, max_deviation, clock_taps, state)[0]


def zero_crossing_f32(x: np.ndarray, sps: float, state: dict | None = None):
    """Native fixed-clock zero-crossing recovery (``rr_zero_crossing``) from
    ``state`` (None: a fresh stream): the exact u32/f32 recurrence of the
    JAX package's ``ops.zero_crossing_sync`` (reference
    src/zero_crossing.rs).  Returns ``(symbols, final_state)``: an f32
    numpy array and a dict with the scan's keys (``last_sign`` bool,
    ``last_cross`` f32, ``counter`` u32), as ``rustradio_tpu/native.py:
    350`` returns it, so a stream resumes across the two packages."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    st = np.zeros(3, np.float32)
    if state is not None:
        st[0] = 1.0 if bool(state["last_sign"]) else 0.0
        st[1] = _f32(state["last_cross"])
        st[2] = np.float32(int(state["counter"]))
    vals = np.empty(len(x), np.float32)
    k = lib.rr_zero_crossing(_ptr(x), len(x), ctypes.c_float(np.float32(sps)),
                             _ptr(st), _ptr(vals))
    final = dict(last_sign=bool(st[0] != 0.0), last_cross=np.float32(st[1]),
                 counter=np.uint32(st[2]))
    return vals[:k].copy(), final


class HdlcDeframer:
    """Native resumable HDLC deframer (``rr_hdlc_*``), the exact port of
    ``ops.hdlc.HdlcStateMachine``: ``feed()`` takes consecutive bit chunks
    and returns the newly decoded (bytes, stream_pos) packets."""

    def __init__(self, min_size=1, max_size=1500, keep_checksum=False,
                 fix_bits=False):
        self._lib = load()
        self._ptr = self._lib.rr_hdlc_create(
            int(min_size), int(max_size), int(bool(keep_checksum)),
            int(bool(fix_bits)))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rr_hdlc_destroy(self._ptr)
            self._ptr = None

    def feed(self, bits) -> list:
        bits = np.ascontiguousarray(bits, np.uint8)
        k = self._lib.rr_hdlc_feed(self._ptr, _ptr(bits), len(bits))
        if k == 0:
            return []
        data = np.empty(self._lib.rr_hdlc_pending_bytes(self._ptr), np.uint8)
        lens = np.empty(k, np.uint32)
        poss = np.empty(k, np.uint64)
        got = self._lib.rr_hdlc_drain(self._ptr, _ptr(data), _ptr(lens),
                                      _ptr(poss), k)
        if got != k:
            raise RuntimeError(f"rr_hdlc_drain returned {got} of {k} packets")
        out, off = [], 0
        for ln, pos in zip(lens, poss):
            out.append((data[off : off + int(ln)].copy(), int(pos)))
            off += int(ln)
        return out

    @property
    def stats(self) -> dict:
        buf = (ctypes.c_uint64 * 3)()
        self._lib.rr_hdlc_stats(self._ptr, buf)
        return {"decoded": int(buf[0]), "crc_error": int(buf[1]),
                "bitfixed": int(buf[2])}
