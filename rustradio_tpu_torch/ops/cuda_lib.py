"""Build and load the port's CUDA kernels.

Every ``rustradio_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
loaded with ``ctypes``; the ``*.cuh`` headers beside them are included by
the sources.  The library lands in ``rustradio_tpu_torch/_build/``
(git-ignored; :mod:`.._buildcache`), named by a hash of every file in
``csrc/`` and the flags, so a changed source rebuilds and an unchanged one
is a cache hit.  The build happens at
first use, never at import: a machine without ``nvcc`` imports every
module and runs the plain versions on CPU tensors.  A failed build raises.

:func:`build` also makes a second library from another directory of
sources (``tools/csrc/``: the yardsticks of ``tools/time_sync.py``, which
include the headers of ``csrc/``), so that nothing but the kernels of the
paths is compiled into, or bound from, the library every user loads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import tempfile
import time
from pathlib import Path

from .. import _buildcache

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = _buildcache.BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR),
)
LINK_FLAGS = ("-shared",)

# what the last build() did: {"path", "cached", "seconds"}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def sources(src_dir: Path = CSRC_DIR) -> list[Path]:
    return sorted(src_dir.glob("*.cu"))


def library_path(src_dir: Path = CSRC_DIR, prefix: str = "librr_cuda") -> Path:
    """The library's file, named by the flags and every file of ``csrc/``
    (and of ``src_dir``, where that is another directory: its sources may
    include the headers of ``csrc/``)."""
    parts = [" ".join(NVCC_FLAGS[:-2]), " ".join(LINK_FLAGS)]
    for folder in dict.fromkeys((CSRC_DIR, src_dir)):
        for src in sorted(folder.iterdir()):
            parts += [src.name, src.read_bytes()]
    return _buildcache.hashed_path(BUILD_DIR, prefix, parts)


def build(src_dir: Path = CSRC_DIR, prefix: str = "librr_cuda") -> Path:
    """Compile ``src_dir``/*.cu unless a library of the same hash exists:
    the sources in parallel into objects in a temporary directory, then
    one link."""
    out = library_path(src_dir, prefix)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        def compile_then_link(tmp: Path) -> list[str]:
            nvcc = _nvcc()
            srcs = sources(src_dir)
            objs = [str(Path(tmpdir) / f"{src.stem}.o") for src in srcs]
            _buildcache.run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                                 for src, obj in zip(srcs, objs)])
            return [nvcc, *LINK_FLAGS, "-o", str(tmp), *objs]

        cached = _buildcache.build(out, compile_then_link)
    if src_dir == CSRC_DIR:
        BUILD_INFO.update(path=str(out), cached=cached,
                          seconds=0.0 if cached else time.perf_counter() - t0)
    return out


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rr_fir_decimate.argtypes = [p, i, ll, p, i, i, p, ll, p]
    lib.rr_fir_decimate.restype = i
    lib.rr_fm_chain.argtypes = [i, p, p, ll, ll, f, p, i, i, ll, ll, f, f, f,
                                p, p, p, p]
    lib.rr_fm_chain.restype = i
    lib.rr_quad_demod.argtypes = [p, ll, f, p, p]
    lib.rr_quad_demod.restype = i
    lib.rr_symbol_sync_scan.argtypes = [p, i, ll, f, f, p, i, p, i, p, p, p]
    lib.rr_symbol_sync_scan.restype = i
    lib.rr_symbol_sync_events.argtypes = [p, p, i, i, i, f, f, p, i, p, i, p,
                                          p, p, p]
    lib.rr_symbol_sync_events.restype = i
    lib.rr_cma_equalize.argtypes = [p, ll, i, f, f, p, p, p]
    lib.rr_cma_equalize.restype = i
    lib.rr_iir_filter.argtypes = [p, ll, p, i, p, p, p, p, p, p]
    lib.rr_iir_filter.restype = i
    lib.rr_iir_layout.argtypes = [p]
    lib.rr_iir_layout.restype = None
    lib.rr_cuda_error_string.argtypes = [i]
    lib.rr_cuda_error_string.restype = ctypes.c_char_p
    return lib


_LIBRARY = _buildcache.Library(build, _bind)


_loaded = None


def load():
    """The kernel library, built on first call (later calls return it
    without taking the build lock)."""
    global _loaded
    if _loaded is None:
        _loaded = _LIBRARY.load()
    return _loaded


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    cudaGetLastError() right after the launch)."""
    if code != 0:
        msg = load().rr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
