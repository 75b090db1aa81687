"""The port imports neither jax nor the JAX package, and runs with both
blocked."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# an import hook that refuses jax, jaxlib and the JAX package outright
_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "rustradio_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, _Block())
"""

_PROBE = _BLOCK + """
import importlib, pkgutil
import rustradio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rustradio_tpu"))
print(len(names), " ".join(names), bad)
assert not bad, bad
"""

# a small end-to-end run of the new slice: frame a packet with the port's
# own HDLC, make its AFSK, decode it (native tail included); and kernel C's
# op entry point
_RUN = _BLOCK + """
import numpy as np, torch
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.models import ax25
bits = ops.hdlc_frame(ops.fcs_add(np.frombuffer(b"NO JAX HERE", np.uint8)))
line = ops.nrzi_encode(torch.from_numpy(bits)).numpy()
fs = 24000.0
at = np.minimum((np.arange(int(len(line) * 20)) / 20).astype(int), len(line) - 1)
audio = np.sin(np.cumsum(2 * np.pi * np.where(line[at] == 1, 1200.0, 2200.0) / fs))
audio = np.concatenate([np.zeros(400), 0.5 * audio, np.zeros(400)])
got = [bytes(p) for p in ax25.ax25_1200_rx(audio, fs, device="cpu")]
assert got == [b"NO JAX HERE"], got
x = torch.polar(torch.ones(64), torch.arange(64) * 0.1).to(torch.complex64)
assert torch.allclose(ops.quad_demod_fast(x), torch.full((63,), 0.1), atol=1e-4)
print("ok")
"""


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_torch_port_never_imports_jax():
    out = _run(_PROBE).split()
    assert int(out[0]) >= 28  # every module of the package was imported
    for name in ("models.ax25", "native", "ops.fft_filter", "ops.hdlc",
                 "ops.hilbert", "ops.resampler", "ops.symbol_sync",
                 "ops.elementwise", "ops.nrzi"):
        assert f"rustradio_tpu_torch.{name}" in out


def test_torch_ax25_decodes_with_jax_blocked():
    assert _run(_RUN).strip().endswith("ok")
