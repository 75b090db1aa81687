"""Build-once cache of the port's native libraries.

A library is compiled at first use, never at import, into
``rustradio_tpu_torch/_build/`` (git-ignored).  Its file is named by a
hash of everything that decides its machine code (the sources, the flags
and, where a flag depends on the host, what the compiler resolves it to),
so a changed input rebuilds and an unchanged one is a cache hit.  The
compiler writes a temp file that is then renamed over the name
(``os.replace``): concurrent processes never load a half-written library.
A failed build raises with the command and the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def hashed_path(build_dir: Path, prefix: str,
                parts: Iterable[bytes | str]) -> Path:
    """``build_dir/<prefix>_<hash of parts>.so``."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part.encode() if isinstance(part, str) else part)
    return build_dir / f"{prefix}_{h.hexdigest()[:16]}.so"


def _failed(cmd: list[str], code: int, stderr: str) -> RuntimeError:
    return RuntimeError(f"{Path(cmd[0]).name} failed (exit {code}): "
                        f"{' '.join(cmd)}\n{stderr}")


def run_all(commands: list[list[str]]) -> None:
    """Run the compile commands concurrently, wait for all of them, and
    raise with the first failure's command and output."""
    procs = []
    try:
        for cmd in commands:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    except OSError as e:
        raise RuntimeError(f"{Path(cmd[0]).name} not runnable: "
                           f"{' '.join(cmd)}\n{e}") from e
    finally:
        # every started compiler is waited for, also when a later one
        # could not start
        done = [(cmd, p.communicate()[1], p.returncode) for cmd, p in procs]
    for cmd, err, code in done:
        if code != 0:
            raise _failed(cmd, code, err)


def build(out: Path, command: Callable[[Path], list[str]]) -> bool:
    """Run ``command(tmp)`` to compile into a temp file beside ``out``,
    then rename it to ``out``; skipped when ``out`` exists.  ``command``
    is called only when building, so it may run earlier steps (such as the
    compiles that its link needs) itself.  Returns True when it was
    skipped."""
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = command(tmp)
    tool = Path(cmd[0]).name
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{tool} not runnable: {' '.join(cmd)}\n{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise _failed(cmd, r.returncode, r.stderr)
    os.replace(tmp, out)
    return False


class Library:
    """The ctypes library that ``build()`` (returning its path) makes and
    ``bind(lib)`` declares, loaded once under a lock.  A failure is
    remembered, so later ``load()`` calls raise it at once."""

    def __init__(self, build: Callable[[], Path], bind: Callable):
        self._build, self._bind = build, bind
        self._lock = threading.Lock()
        self._lib = None
        self._error: RuntimeError | None = None

    def load(self):
        with self._lock:
            if self._lib is None:
                if self._error is not None:
                    raise self._error
                try:
                    self._lib = self._bind(ctypes.CDLL(str(self._build())))
                except (RuntimeError, OSError) as e:
                    self._error = (e if isinstance(e, RuntimeError)
                                   else RuntimeError(str(e)))
                    raise self._error from e
            return self._lib
