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

# a small end-to-end run: frame a packet with the port's own HDLC, make its
# AFSK, decode it (native tail included, then the device clock recovery);
# kernel C's op entry point; and a 16-channel wideband decode
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
# the device clock recovery (kernel D's plain version)
got = [bytes(p) for p in ax25.ax25_1200_rx(audio, fs, sync="events", device="cpu")]
assert got == [b"NO JAX HERE"], got
# the wideband receiver: the packet's audio held up to 512 kHz and FM
# modulated onto channel 3 of a 16-channel capture
from rustradio_tpu_torch.models import multichannel
at32 = np.minimum((np.arange(int(len(line) * 80 / 3)) * 3 / 80).astype(int), len(line) - 1)
a32 = np.sin(np.cumsum(2 * np.pi * np.where(line[at32] == 1, 1200.0, 2200.0) / 32000.0))
a32 = np.concatenate([np.zeros(400), 0.8 * a32, np.zeros(400)])
up = np.repeat(a32, 16)
t = np.arange(len(up)) / 512000.0
iq = np.exp(1j * (2 * np.pi * np.cumsum(3000.0 * up) / 512000.0 + 2 * np.pi * 96000.0 * t))
iq = np.concatenate([iq, np.zeros(4096)]).astype(np.complex64)
res = multichannel.decode_band_ax25(iq, 512000.0, n_channels=16, max_active=2,
                                    sync_method="events", device="cpu")
got = {r.channel: [bytes(p) for p in r.packets] for r in res}
assert got == {3: [b"NO JAX HERE"]}, got
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
    assert int(out[0]) >= 36  # every module of the package was imported
    for name in ("models.ax25", "native", "ops.fft_filter", "ops.hdlc",
                 "ops.hilbert", "ops.resampler", "ops.symbol_sync",
                 "ops.elementwise", "ops.nrzi", "parallel.channelizer",
                 "models.multichannel", "io.rawfile", "apps.scanner",
                 "dtypes"):
        assert f"rustradio_tpu_torch.{name}" in out


def test_torch_ax25_decodes_with_jax_blocked():
    assert _run(_RUN).strip().endswith("ok")
