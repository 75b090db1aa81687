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
        if name.split(".")[0] in ("jax", "jaxlib", "rustradio_tpu", "benches"):
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
             if m.split(".")[0] in ("jax", "jaxlib", "rustradio_tpu", "benches"))
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
# the receiver built from blocks, streamed with a checkpoint and resumed
import tempfile, os
ck = os.path.join(tempfile.mkdtemp(), "c.pkl")
from rustradio_tpu_torch import blocks
from rustradio_tpu_torch.graph import Graph
def graph():
    g, s = Graph(), blocks.PduVectorSink()
    g.chain(blocks.VectorSource(audio.astype(np.float32)), blocks.Hilbert(65),
            blocks.QuadratureDemod(1.0), blocks.AddConst(-2 * np.pi * 1700 / fs),
            blocks.SymbolSync(20.0, 0.5, (0.5, 0.5)), blocks.BinarySlicer(),
            blocks.NrziDecode(), blocks.HdlcDeframer(10, 1500), s)
    return g, s
g, s1 = graph()
g.run_stream(chunk_size=4000, max_chunks=2, checkpoint_path=ck, checkpoint_every=2,
             device="cpu")
g, s2 = graph()
g.run_stream(chunk_size=4000, resume_from=ck, device="cpu")
got = [bytes(p.data) for p in s1.pdus() + s2.pdus()]
assert got == [b"NO JAX HERE"], got
assert ax25.ax25_1200_rx_graph(audio, fs, chunk_size=5000, device="cpu") == got
# rtl_fm on a small u8 capture
from rustradio_tpu_torch.apps import rtl_fm
from rustradio_tpu_torch.io import au, rawfile
d = tempfile.mkdtemp()
t = np.arange(1 << 14) / 256000.0
ph = 2 * np.pi * 10000.0 * np.cumsum(np.sin(2 * np.pi * 1000.0 * t)) / 256000.0
rawfile.rtlsdr_encode(0.6 * np.exp(1j * ph)).tofile(os.path.join(d, "c.u8"))
assert rtl_fm.main(["-r", os.path.join(d, "c.u8"), "--rtl_u8", "--out",
                    os.path.join(d, "a.au"), "--sample_rate", "256k",
                    "--audio_rate", "32k", "--device", "cpu"]) == 0
assert len(au.au_read(os.path.join(d, "a.au"))[0]) == 2048
# the G3RUH modem: transmit two frames, receive them with both clock
# recoveries (the clock bounded to +-0.05 samples: at the default 0.1 the
# default taps hold the clock at its bound and both packages lose the
# second frame), and as bursts through whole-packet clock recovery
two = [b"NO JAX G3RUH ONE", b"NO JAX G3RUH TWO"]
tx = ax25.g3ruh_modulate([np.frombuffer(p, np.uint8) for p in two], 300000.0,
                         device="cpu")
z = torch.zeros(5000, dtype=torch.complex64)
for sync in ("native", "events"):
    got = [bytes(p) for p in ax25.ax25_9600_rx(torch.cat([z, tx, z]), 300000.0,
                                              symbol_max_deviation=0.05, sync=sync)]
    assert got == two, got
parts = [torch.zeros(20000, dtype=torch.complex64)]
for p in two:
    parts += [ax25.g3ruh_modulate([np.frombuffer(p, np.uint8)], 50000.0,
                                  device="cpu"), parts[0]]
got = [bytes(p) for p in ax25.ax25_9600_wpcr_rx(torch.cat(parts), 50000.0)]
assert got == two, got
# the IL2P receiver: one SABM header M0THC-1 -> 2E0QQQ-1 (the header bytes
# as parse_header reads them, scrambled as il2p_descramble unscrambles),
# AFSK at 50 kHz on an FM carrier, through il2p_1200_rx and its app
from rustradio_tpu_torch.ops import il2p
hdr = [(ord(c) - 0x20) & 63 for c in "2E0QQQ"] + [(ord(c) - 0x20) & 63 for c in "M0THC"] + [0] * 2
hdr[0] |= 0x80; hdr[1] |= 0x80; hdr[4] |= 0x40; hdr[9] |= 0x40; hdr[12] = 0x11
raw = np.unpackbits(np.asarray(hdr + [0, 0], np.uint8))
reg, scr = 0x1F0, []
for o in raw:
    i = int(o) ^ (reg & 1); scr.append(i); reg = (reg >> 1) ^ (0x108 * i)
bits = np.concatenate([np.random.RandomState(0).randint(0, 2, 100), il2p.SYNC_WORD,
                       scr, np.random.RandomState(1).randint(0, 2, 100)])
at = np.minimum((np.arange(int(len(bits) * 125 / 3)) * 3 / 125).astype(int), len(bits) - 1)
a50 = 0.5 * np.sin(np.cumsum(2 * np.pi * np.where(bits[at] == 1, 1200.0, 2200.0) / 50000.0))
iq = np.exp(1j * np.cumsum(0.3 * a50 * 2 * np.pi * 3500.0 / 50000.0)).astype(np.complex64)
got = [(h.src, h.dst, h.describe()) for h in ax25.il2p_1200_rx(iq, 50000.0, device="cpu")]
assert got == [("M0THC-1", "2E0QQQ-1", "SABM")], got
from rustradio_tpu_torch.apps import il2p_1200_rx
rawfile.write_samples(os.path.join(d, "il2p.c32"), iq)
assert il2p_1200_rx.main(["-r", os.path.join(d, "il2p.c32"), "--device", "cpu"]) == 0
# rtl_fm from the simulated SDR (hw/)
assert rtl_fm.main(["-r", "sim", "--seconds", "0.01", "--out",
                    os.path.join(d, "s.au"), "--device", "cpu"]) == 0
# the batched streaming runner with its trace, and the generator and
# spectrum apps
g = Graph()
s = blocks.VectorSink()
g.chain(blocks.SignalSourceComplex(48000.0, 1000.0, 0.5, n=1 << 14),
        blocks.FirFilter(np.ones(9, np.float32) / 9, deci=4),
        blocks.QuadratureDemod(1.0), blocks.MultiplyConst(0.5), s)
g.run_stream(chunk_size=1024, scan_chunks=4, device="cpu",
             profile_dir=os.path.join(d, "trace"))
assert len(s.data()) == (1 << 12) - 3 and "GFLOP" in g.generate_stats()
assert "rr::segment:" in open(g.trace_path).read()
from rustradio_tpu_torch.apps import spectrum, tone
assert tone.main(["--out", os.path.join(d, "t.c32"), "--seconds", "0.1",
                  "--device", "cpu"]) == 0
assert spectrum.main(["-r", os.path.join(d, "t.c32"), "--sample_rate", "48k",
                      "--fft_size", "256", "--device", "cpu"]) == 0
# the recurrences: a CMA equalizer streamed against its offline run (within
# 1e-5 of max|y|: kernel F's blocks count from each call's start) and bit
# for bit against the plain recurrence called chunk by chunk as the block
# calls it (333 samples, the last 3 samples and the taps carried), and the
# IIR filter's golden values
from rustradio_tpu_torch.ops import kernels
q = np.exp(2j * np.pi * np.random.RandomState(0).randint(0, 4, 3000) / 4)
def cma(chunk):
    g, s = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource((0.5 * q).astype(np.complex64)),
            blocks.CmaEqualizer(4, 1.0, 1e-2), s)
    g.run(device="cpu") if chunk is None else g.run_stream(chunk_size=chunk, device="cpu")
    return s.data()
whole, streamed = cma(None), cma(333)
assert np.abs(whole - streamed).max() <= 1e-5 * np.abs(whole).max()
xq = torch.from_numpy((0.5 * q).astype(np.complex64))
taps, buf, calls = torch.eye(1, 4, dtype=torch.complex64)[0], xq[:0], []
for lo in range(0, len(xq), 333):
    buf = torch.cat([buf, xq[lo : lo + 333]])
    yc, taps = kernels.cma_scan_plain(buf, taps, 1.0, 1e-2)
    calls.append(yc.numpy())
    buf = buf[-3:]
assert np.array_equal(streamed, np.concatenate(calls))
assert abs(abs(whole[-1]) - 1) < 1e-2
assert ops.iir_filter(torch.full((4,), 100.0), [1.0, 0.9, 0.1]).tolist()[:3] == [100.0, 190.0, 281.0]
# the live feed: downsample_u8 into the stdio DATA_STREAM loop
import io
from rustradio_tpu_torch.apps import rtl_data_stream as rds
from rustradio_tpu_torch.io import data_stream
raw = rawfile.rtlsdr_encode(0.5 * np.exp(1j * np.arange(20000) * 0.1))
payload = rds.downsample_u8(raw, 250e3, 50e3, device="cpu")
out = io.BytesIO()
rds.serve_stdio(payload, io.BytesIO(data_stream.encode_version()
                + data_stream.encode_request_data("rtl-sdr", 10 ** 6)), out)
ev = data_stream.BytesReader().feed(out.getvalue())
assert b"".join(e[2] for e in ev if e[0] == "data") == payload and len(payload) == 8000
# the multi-device layer and the small public names: a sharded FM chain over
# 4 CPU shards against the offline chain, a shard chain of blocks, the
# channel-sharded bank, and the names of the package's top level
import numpy as np, torch
import rustradio_tpu_torch as rr
from rustradio_tpu_torch import ops, taps, windows
from rustradio_tpu_torch.parallel import (make_mesh, sharded_fm_demod,
                                          sharded_channelizer_fm, channelizer_taps)
from rustradio_tpu_torch.parallel.graph_mesh import shard_chain
from rustradio_tpu_torch.tools import dryrun
from rustradio_tpu_torch.streams import StreamValue, scale_tags, shift_tags, filter_tags
from rustradio_tpu_torch.utils import RateMeter, roofline_report
mesh = make_mesh(4, device="cpu")
lp = taps.low_pass_complex(1.024e6, 100e3, 50e3)
x = torch.polar(torch.ones(4096), torch.arange(4096) * 0.05).to(torch.complex64)
got = sharded_fm_demod(x, lp, mesh, deci=4)
want = ops.quadrature_demod(ops.fir_filter(x, lp, 4), 1.0)
m = min(len(got), len(want))
assert m >= len(want) - 1 and float((got[:m] - want[:m]).abs().max()) < 1e-5
from rustradio_tpu_torch import blocks
y = shard_chain([blocks.Hilbert(65), blocks.QuadratureDemod(1.0)], mesh)(x.real.contiguous())
assert y.shape == (4095,)
assert sharded_channelizer_fm(x, channelizer_taps(16, 4), 16,
                              make_mesh(4, axis="chan", device="cpu")).shape == (255, 16)
assert rr.parse_verbosity("info") == 2 and rr.Complex is torch.complex64
assert taps.multiband([(0.0, 0.2)], 64, windows.hamming(64)).dtype == np.complex64
f, r = ops.hdlc_bit_hunt(torch.tensor([0, 1, 1, 1, 1, 1, 1, 0], dtype=torch.uint8))
assert f.tolist()[-1] and r.tolist()[-2] == 6
# the streaming half: a Graph streamed on the mesh (a ragged last chunk
# demotes its segment) against the unsharded stream, and a stage pipeline
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.parallel import pipeline_run_rates
def stream(mesh_):
    g, s = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.FirFilter(lp, 4),
            blocks.QuadratureDemod(1.0), s)
    g.run_stream(chunk_size=1024, device="cpu", mesh=mesh_)
    return s.data(), g.demotions
(a, d), (b, _) = stream(mesh), stream(None)
assert a.shape == b.shape and np.abs(a - b).max() < 1e-5 and d == []
p = pipeline_run_rates([(lambda v: v.reshape(-1, 4).mean(1), 64, 16),
                        (lambda v: v * 2, 16, 16)],
                       x[:256].reshape(4, 64), make_mesh(2, axis="stage", device="cpu"))
assert torch.equal(p, x[:256].reshape(64, 4).mean(1).reshape(4, 16) * 2)
# a (chan, time) mesh: the FM chain over time, the stream on the mesh and a
# pipeline along chan, each the run on the 1-D mesh of the axis's size
from rustradio_tpu_torch.parallel import make_mesh_2d, pipeline_run
m2, m1 = make_mesh_2d(2, 2, device="cpu"), make_mesh(2, device="cpu")
assert torch.equal(sharded_fm_demod(x, lp, m2, deci=4), sharded_fm_demod(x, lp, m1, deci=4))
assert np.array_equal(stream(m2)[0], stream(m1)[0])
c = x.real[:256].reshape(4, 64).contiguous()
assert torch.equal(pipeline_run([lambda v: v * 2, lambda v: v + 1], c, m2, axis="chan"),
                   c * 2 + 1)
# the benchmark programs on the plain versions at their small sizes
from rustradio_tpu_torch.tools import bench, bench_kernels, check_fm_accuracy
for prog, args in ((bench_kernels, ["--only", "quad_demod,native"]), (bench, []),
                   (check_fm_accuracy, [])):
    assert prog.main(["--device", "cpu", "--small"] + args) == 0
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
    assert int(out[0]) >= 95  # every module of the package was imported
    for name in ("models.ax25", "native", "ops.fft_filter", "ops.hdlc",
                 "ops.hilbert", "ops.resampler", "ops.symbol_sync",
                 "ops.elementwise", "ops.nrzi", "parallel.channelizer",
                 "models.multichannel", "io.rawfile", "apps.scanner",
                 "dtypes", "graph", "convert", "ops.iir", "io.au",
                 "utils.checkpoint", "blocks.digital", "blocks.packets",
                 "apps.rtl_fm", "apps.am_decode", "models.fm",
                 "ops.scramble", "ops.vco", "ops.delay", "ops.burst",
                 "ops.wpcr", "blocks.rate", "blocks.demod", "blocks.filters",
                 "apps.ax25_9600_rx", "apps.ax25_1200_wpcr",
                 "apps.ax25_9600_wpcr", "apps.g3ruh", "apps.burst_saver",
                 "ops.correlate", "ops.il2p", "io.sigmf", "hw", "hw.driver",
                 "hw.source", "hw.sink", "hw.rtl", "hw.soapy", "hw.pipewire",
                 "apps.ax25_1200_rx", "apps.il2p_1200_rx", "apps.bell202_tx",
                 "apps.capture", "apps.soapy_fm", "ops.signal", "ops.fft",
                 "utils.stats", "utils.waterfall", "apps.tone", "apps.fm_tx",
                 "apps.morse_beacon", "apps.spectrum", "apps.pw_tone",
                 "ops.cma", "blocks.io_blocks", "runtime", "io.data_stream",
                 "io.websocket", "ui", "ui.server", "apps.rtl_data_stream",
                 "apps.ui_server", "parallel", "parallel.mesh", "parallel.halo",
                 "parallel.sharded", "parallel.graph_mesh", "parallel.pipeline",
                 "tools.dryrun", "tools.bench", "tools.bench_kernels",
                 "tools.check_fm_accuracy", "tools.timing", "tools.corpus"):
        assert f"rustradio_tpu_torch.{name}" in out


def test_torch_ax25_decodes_with_jax_blocked():
    assert _run(_RUN).strip().endswith("ok")
