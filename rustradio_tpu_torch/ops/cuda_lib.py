"""Build and load the port's CUDA kernels.

Every ``rustradio_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in ``rustradio_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is a cache hit.  The build happens at
first use, never at import: a machine without ``nvcc`` imports every
module and runs the plain versions on CPU tensors.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# what the last load() did: {"path", "cached", "seconds"}
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librr_cuda_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), cached=True, seconds=0.0)
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {r.returncode}): {' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), cached=False,
                      seconds=time.perf_counter() - t0)
    return out


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rr_fir_decimate.argtypes = [p, ll, p, i, i, p, ll, p]
    lib.rr_fir_decimate.restype = i
    lib.rr_fm_chain.argtypes = [i, p, p, ll, ll, f, p, i, i, ll, ll, f, f, f,
                                p, p, p, p]
    lib.rr_fm_chain.restype = i
    lib.rr_cuda_error_string.argtypes = [i]
    lib.rr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    cudaGetLastError() right after the launch)."""
    if code != 0:
        msg = load().rr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
