"""The port's SDR layer (``rustradio_tpu_torch/hw``) against the JAX
package's: ``tests/test_hw.py``'s cases run on both packages' copies.

The simulated driver's samples are compared bit for bit (the same seed and
reads give the same complex64 samples); tags are compared key, value and
position; the port's sources emit tensors on the device the runner names
(the CPU here).  The hardware modules (``rtlsdr``, ``SoapySDR``,
``sounddevice``) are absent, as the import guards expect; the RTL adapter
runs over a fake ``rtlsdr`` module.
"""

import io
import sys
import types

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu import hw as jhw
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.hw.driver import parse_sim_tone as jparse_sim_tone
from rustradio_tpu_torch import blocks, hw
from rustradio_tpu_torch.blocks.base import Block
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.hw.driver import parse_sim_tone, sim_driver
from rustradio_tpu_torch.io import rawfile

CPU = torch.device("cpu")


def _peak_freq(x, fs):
    spec = np.abs(np.fft.fft(np.asarray(x)))
    return np.fft.fftfreq(len(x), 1 / fs)[int(np.argmax(spec))]


def _tags(tags):
    return [(t.pos, t.key, t.val) for t in tags]


class Watch(Block):
    """Host pass-through that hands each chunk to ``fn`` (the JAX test's
    ``blocks.Map``, which the port does not have yet)."""

    domain = "host"

    def __init__(self, fn):
        self.fn = fn

    def apply(self, x):
        self.fn(x)
        return x


class RtlDecode(Block):
    """u8 wire bytes -> complex64 (the JAX package's ``RtlSdrDecode``)."""

    domain = "host"

    def apply(self, x):
        return torch.from_numpy(rawfile.rtlsdr_decode(x.cpu().numpy()))


SIM = dict(frequency=1e6, sample_rate=100_000.0, gain=0.7,
           tones=[(1e6 + 10_000.0, 1.0), (1e6 - 30_000.0, 0.2), (2e6, 1.0)],
           fm_tones=[(1e6 + 5_000.0, 0.5, 700.0, 3_000.0)], noise=0.05, seed=3,
           total_samples=20_000)


def test_torch_sim_driver_samples_equal_jax():
    d, j = hw.SimDriver(**SIM), jhw.SimDriver(**SIM)
    for n in (1, 1000, 4096, 333):
        assert np.array_equal(d.read(n), j.read(n))
    for drv in (d, j):  # a retune and a rate change between reads
        drv.set_frequency(2e6 - 5_000.0)
        drv.set_sample_rate(50_000.0)
        drv.set_gain(1.0)
    a, b = d.read(8192), j.read(8192)
    assert a.dtype == np.complex64 and np.array_equal(a, b)
    assert abs(_peak_freq(a, 50_000.0) - 5_000.0) < 50_000.0 / 8192 * 2
    # the finite stream ends at total_samples, then reads empty
    assert len(d.read(10_000)) == 20_000 - 13_622 == len(j.read(10_000))
    assert len(d.read(5)) == 0
    assert d.command_log == j.command_log
    assert d.sensors() == j.sensors() and d.time_ns() == j.time_ns()
    d.write(a[:10])
    assert np.array_equal(d.tx_data(), a[:10])


def test_torch_sim_driver_tone_at_offset():
    fs = 100_000.0
    d = hw.SimDriver(frequency=1e6, sample_rate=fs, gain=1.0,
                     tones=[(1e6 + 10_000.0, 1.0)])
    assert abs(_peak_freq(d.read(4096), fs) - 10_000.0) < fs / 4096 * 2


@pytest.mark.parametrize("spec", ["145.2M:0.5", "100m:0.8:1k:37.5k", "1e6:1"])
def test_torch_parse_sim_tone_equals_jax(spec):
    assert parse_sim_tone(spec) == jparse_sim_tone(spec)


def test_torch_parse_sim_tone_rejects():
    with pytest.raises(ValueError, match="FREQ:AMP"):
        parse_sim_tone("1:2:3")


@pytest.mark.parametrize("specs", [[], ["100.2M:0.5", "99.9M:0.8:1k:37.5k"]])
def test_torch_sim_driver_of_the_apps_equals_jax(specs):
    # the apps' -r sim driver: the --sim_tone specs split into CW and FM
    # tones as the JAX apps split them, or the app's defaults
    default = [(100e6 + 0.2e6, 0.5), (100e6, 0.8, 1_000.0, 37_500.0)]
    d = sim_driver(100e6, 1.024e6, specs, default)
    tones = [jparse_sim_tone(s) for s in specs] or default
    j = jhw.SimDriver(frequency=100e6, sample_rate=1.024e6, gain=1.0,
                      tones=[t for t in tones if len(t) == 2],
                      fm_tones=[t for t in tones if len(t) == 4])
    assert (d.tones, d.fm_tones) == (j.tones, j.fm_tones)
    assert np.array_equal(d.read(4096), j.read(4096))


def _run_source(mod, graph_cls, src, **kw):
    g = graph_cls()
    sink = g.add(mod.VectorSink(), g.add(src))
    if graph_cls is Graph:
        kw["device"] = "cpu"
    g.run_stream(**kw)
    return sink.block


def test_torch_sdr_source_start_and_telemetry_tags():
    fs = 10_000.0
    mk = dict(frequency=1e6, sample_rate=fs, tones=[(1e6, 0.5)])
    sink = _run_source(blocks, Graph, hw.SdrSource(hw.SimDriver(**mk)),
                       chunk_size=5_000, max_chunks=6)
    jsink = _run_source(jblocks, JGraph, jhw.SdrSource(jhw.SimDriver(**mk)),
                        chunk_size=5_000, max_chunks=6)
    tags = sink.tags()
    assert _tags(tags) == _tags(jsink.tags())
    assert np.array_equal(sink.data(), np.asarray(jsink.data()))
    keys = [t.key for t in tags]
    for k in ("frequency", "sample_rate", "input_gain", "driver", "hardware",
              "channel"):
        assert f"SdrSource::{k}" in keys
    time_tags = [t for t in tags if t.key == "SdrSource::time_ns"]
    assert len(time_tags) == 3 and [t.pos for t in time_tags] == [0, 10_000, 20_000]
    assert time_tags[1].val - time_tags[0].val == pytest.approx(1e9)
    assert any(t.key == "SdrSource::sensor_ref_locked" for t in tags)
    assert not any(t.key == "SdrSource::sensor_temp" for t in tags)


def test_torch_mid_stream_retune_takes_effect_and_is_tagged():
    fs = 100_000.0
    mk = dict(frequency=1e6, sample_rate=fs, gain=1.0,
              tones=[(1e6 + 10_000.0, 1.0), (3e6 + 20_000.0, 1.0)])
    runs = {}
    for name, mod, hwm, graph_cls, watch in (
            ("port", blocks, hw, Graph, Watch),
            ("jax", jblocks, jhw, JGraph, None)):
        d = hwm.SimDriver(**mk)
        src = hwm.SdrSource(d)
        ctl = src.control()
        chunks = []

        def fn(x, chunks=chunks, ctl=ctl):
            chunks.append(np.asarray(x.cpu() if torch.is_tensor(x) else x))
            if len(chunks) == 2:
                ctl.set_frequency(3e6)  # retune while the graph runs
            return x

        g = graph_cls()
        if watch is None:
            m = g.add(mod.Map(fn, "watch"), g.add(src))
            m.block.domain = "host"
        else:
            m = g.add(watch(fn), g.add(src))
        sink = g.add(mod.VectorSink(), m)
        kw = {"device": "cpu"} if graph_cls is Graph else {}
        g.run_stream(chunk_size=8192, max_chunks=5, **kw)
        runs[name] = (chunks, sink.block, d)
    chunks, sink, d = runs["port"]
    assert abs(_peak_freq(chunks[0], fs) - 10_000.0) < 50
    assert abs(_peak_freq(chunks[4], fs) - 20_000.0) < 50
    ftags = [t for t in sink.tags() if t.key == "SdrSource::frequency" and t.val == 3e6]
    assert len(ftags) == 1 and ftags[0].pos == 2 * 8192
    assert ("frequency", 3e6) in d.command_log
    jchunks, jsink, _ = runs["jax"]
    assert all(np.array_equal(a, b) for a, b in zip(chunks, jchunks))
    assert _tags(sink.tags()) == _tags(jsink.tags())


def test_torch_sdr_source_offline_run_and_device():
    # Graph.run emits once and reads the tags of that emit
    d = hw.SimDriver(frequency=0.0, sample_rate=1000.0, tones=[(100.0, 1.0)])
    src = hw.SdrSource(d, n=3000)
    out = src.emit(0, 7, CPU)
    assert torch.is_tensor(out) and out.dtype == torch.complex64 and out.device == CPU
    g = Graph()
    sink = g.add(blocks.VectorSink(), g.add(hw.SdrSource(
        hw.SimDriver(frequency=0.0, sample_rate=1000.0), n=3000)))
    g.run(device="cpu")
    assert len(sink.block.data()) == 3000
    assert {"SdrSource::frequency", "SdrSource::time_ns"} <= {
        t.key for t in sink.block.tags()}
    with pytest.raises(ValueError, match="unbounded"):
        Graph().chain(hw.SdrSource(d), blocks.VectorSink()).graph.run(device="cpu")


def test_torch_overflow_tagged():
    d = hw.SimDriver(frequency=0.0, sample_rate=1000.0)
    src = hw.SdrSource(d)
    src.emit(0, 100, CPU)
    d.inject_overflow(3)
    src.emit(100, 100, CPU)
    assert any(t.key == "SdrSource::overflow" and t.val == 3
               for t in src.emit_tags(100, 100))
    src.emit(200, 100, CPU)
    assert not any(t.key == "SdrSource::overflow" for t in src.emit_tags(200, 100))


def test_torch_rtl_source_bytes_equal_jax():
    fs = 50_000.0
    mk = dict(frequency=1e6, sample_rate=fs, gain=1.0, tones=[(1e6 + 4_000.0, 0.5)])
    g = Graph()
    s = g.add(hw.RtlSdrSource(hw.SimDriver(**mk)))
    sink = g.add(blocks.VectorSink(), g.add(RtlDecode(), s))
    raw = g.add(blocks.VectorSink(), s)
    g.run_stream(chunk_size=8192, max_chunks=2, device="cpu")
    x = sink.block.data()
    assert x.dtype == np.complex64 and len(x) == 8192
    assert abs(_peak_freq(x, fs) - 4_000.0) < 50
    jsrc = jhw.RtlSdrSource(jhw.SimDriver(**mk))
    want, want_tags = [], []
    for off in (0, 8192):
        want.append(jsrc.emit(off, 8192))
        want_tags += [(t.pos + off, t.key, t.val) for t in jsrc.emit_tags(off, 8192)]
    assert raw.block.data().dtype == np.uint8
    assert np.array_equal(raw.block.data(), np.concatenate(want))
    assert _tags(raw.block.tags()) == want_tags


def test_torch_rtl_control_db_mapping():
    d = hw.SimDriver(frequency=1e6, sample_rate=1e6)
    src = hw.RtlSdrSource(d)
    ctl = src.control()
    ctl.set_center_freq_hz(144_800_000)
    ctl.set_gain_db(25)
    src.emit(0, 1024, CPU)
    assert d.frequency == 144_800_000.0
    assert d.gain == pytest.approx(0.5)
    keys = {t.key for t in src.emit_tags(0, 1024)}
    assert {"RtlSdrSource::frequency", "RtlSdrSource::input_gain"} <= keys


def test_torch_sdr_sink_loopback_tx():
    d = hw.SimDriver(frequency=1e6, sample_rate=48_000.0)
    tx = (np.exp(2j * np.pi * 0.01 * np.arange(1000)) * 0.3).astype(np.complex64)
    g = Graph()
    g.chain(blocks.VectorSource(tx), hw.SdrSink(d, ogain=0.9))
    g.run(device="cpu")
    assert np.array_equal(d.tx_data(), tx) and d.gain == 0.9
    g = Graph()  # streamed: the chunks in order
    d2 = hw.SimDriver(frequency=1e6, sample_rate=48_000.0)
    g.chain(blocks.VectorSource(tx), hw.SdrSink(d2))
    g.run_stream(chunk_size=300, device="cpu")
    assert np.array_equal(d2.tx_data(), tx) and len(d2.tx_samples) == 4


def test_torch_soapy_builder_tags_equal_jax():
    def build(mod):
        d = mod.SimDriver(frequency=0.0, sample_rate=1.0)
        src = (mod.SoapySdrSource(d, 433_000_000.0, 1_000_000.0)
               .channel(1).igain(0.7).antenna("LNAW").gps_coordinates(True)
               .build())
        return d, src

    d, src = build(hw)
    assert d.frequency == 433_000_000.0 and d.sample_rate == 1_000_000.0
    src.emit(0, 16, CPU)
    jd, jsrc = build(jhw)
    jsrc.emit(0, 16)
    assert _tags(src.emit_tags(0, 16)) == _tags(jsrc.emit_tags(0, 16))
    kv = {t.key: t.val for t in src.emit_tags(0, 16)}
    assert kv["SoapySdrSource::channel"] == 1
    assert kv["SoapySdrSource::input_gain"] == pytest.approx(0.7)
    assert kv["SoapySdrSource::antenna"] == "LNAW"
    assert "SoapySdrSource::sensor_ref_locked" in kv
    sink = hw.SoapySdrSink(hw.SimDriver(0.0, 1.0), 145e6, 48_000.0, ogain=0.3)
    assert (sink.driver.frequency, sink.driver.sample_rate, sink.driver.gain) == \
        (145e6, 48_000.0, 0.3)


def test_torch_soapy_driver_needs_bindings():
    with pytest.raises(ImportError, match="SimDriver"):
        hw.soapy.SoapyDriver("driver=rtlsdr", 1e8, 1e6)


def test_torch_audio_sink_backends(tmp_path):
    path = str(tmp_path / "audio.f32")
    audio = np.sin(np.linspace(0, 20, 4800)).astype(np.float32)
    g = Graph()
    g.chain(blocks.VectorSource(audio), hw.AudioSink(48_000, backend="file", path=path))
    g.run_stream(chunk_size=1000, device="cpu")
    g.nodes[-1].block.finish()
    assert np.array_equal(np.fromfile(path, "<f4"), audio)
    g = Graph()
    g.chain(blocks.VectorSource(np.zeros(100, np.float32)),
            hw.AudioSink(48_000, backend="null"))
    g.run(device="cpu")
    with pytest.raises(ValueError, match="path="):
        hw.AudioSink(48_000, backend="file")
    # the auto-detected backend of both packages on this host
    assert hw.sink._detect_audio_backend(48_000) == \
        jhw.sink._detect_audio_backend(48_000)


def test_torch_pipewire_sink_writer_and_source_command(tmp_path):
    buf = io.BytesIO()
    audio = np.linspace(-1, 1, 256).astype(np.float32)
    g = Graph()
    g.chain(blocks.VectorSource(audio), hw.PipewireSink(48_000, writer=buf))
    g.run(device="cpu")
    assert np.array_equal(np.frombuffer(buf.getvalue(), "<f4"), audio)

    path = str(tmp_path / "in.f32")
    np.arange(1000, dtype="<f4").tofile(path)
    src = hw.PipewireSource(48_000, command=["cat", path])
    g = Graph()
    sink = g.add(blocks.VectorSink(), g.add(src))
    g.run_stream(chunk_size=256, max_chunks=10, device="cpu")
    assert np.array_equal(sink.block.data(), np.arange(1000, dtype=np.float32))
    assert src.exhausted()
    src.finish()


def test_torch_fm_receive_from_sim_driver():
    # end-to-end: FM-modulated RF tone through SdrSource -> demod chain
    fs, audio_f, dev, n = 256_000.0, 1_000.0, 5_000.0, 1 << 16
    t = np.arange(n) / fs
    phase = 2 * np.pi * np.cumsum(dev * np.sin(2 * np.pi * audio_f * t)) / fs
    base = np.exp(1j * phase).astype(np.complex64)

    class FmDriver(hw.SimDriver):
        def read(self, nn):
            out = base[self._count : self._count + nn]
            self._count += len(out)
            self._elapsed += len(out) / self.sample_rate
            return out

    g = Graph()
    s = g.add(hw.SdrSource(FmDriver(frequency=1e8, sample_rate=fs), n=n))
    sink = g.add(blocks.VectorSink(), g.add(blocks.QuadratureDemod(1.0), s))
    g.run_stream(chunk_size=16_384, device="cpu")
    y = sink.block.data()
    assert len(y) == n - 1
    assert abs(abs(_peak_freq(y[1000:9192], fs)) - audio_f) < 40


def _fake_rtlsdr(monkeypatch, calls):
    class FakeRtlSdr:
        valid_gains_db = [0.0, 9.7, 20.7, 33.8, 49.6]

        def __init__(self, device_index=0):
            calls.append(("open", device_index))

        def __setattr__(self, k, v):
            if k in ("sample_rate", "center_freq", "gain"):
                calls.append((k, v))
            object.__setattr__(self, k, v)

        _pos = 0

        def read_samples(self, n):
            assert n % 512 == 0  # librtlsdr buffer-size rule
            t = np.arange(self._pos, self._pos + n)
            object.__setattr__(self, "_pos", self._pos + n)
            return (np.exp(2j * np.pi * 0.01 * t) * 0.5).astype(np.complex128)

        def close(self):
            calls.append(("close", None))

    fake = types.ModuleType("rtlsdr")
    fake.RtlSdr = FakeRtlSdr
    monkeypatch.setitem(sys.modules, "rtlsdr", fake)


def test_torch_rtl_driver_contract(monkeypatch):
    """``RtlDriver`` over a fake pyrtlsdr module, as tests/test_hw.py holds
    the JAX package's: gain mapped onto the supported list, retunes
    forwarded, complex64 reads buffered across the 512-sample rule,
    stream-time ``time_ns``; the two packages' reads equal."""
    calls = []
    _fake_rtlsdr(monkeypatch, calls)
    from rustradio_tpu.hw.rtl import RtlDriver as JRtlDriver

    drv = hw.RtlDriver(frequency=144.8e6, sample_rate=1.024e6, gain=0.4,
                       device_index=1)
    for c in (("open", 1), ("sample_rate", 1.024e6), ("center_freq", 144.8e6),
              ("gain", 20.7)):
        assert c in calls
    x = drv.read(1000)
    assert x.dtype == np.complex64 and len(x) == 1000
    assert drv.time_ns() == int(1000 / 1.024e6 * 1e9)
    y = drv.read(1000)
    jdrv = JRtlDriver(frequency=144.8e6, sample_rate=1.024e6, gain=0.4)
    assert np.array_equal(np.concatenate([x, y]),
                          np.concatenate([jdrv.read(1000), jdrv.read(1000)]))
    drv.set_frequency(145.0e6)
    assert ("center_freq", 145.0e6) in calls
    drv.set_gain(1.0)
    assert ("gain", 49.6) in calls
    src = hw.RtlSdrSource(drv)
    raw = src.emit(0, 2048, CPU)
    assert raw.dtype == torch.uint8 and raw.shape == (2048,)
    assert "RtlSdrSource::frequency" in {t.key for t in src.emit_tags(0, 2048)}
    assert drv.info() == {"driver": "rtlsdr", "hardware": "rtl1"}
    drv.close()
    assert ("close", None) in calls


def test_torch_rtl_driver_import_error_without_bindings(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtlsdr", None)  # import raises
    with pytest.raises(ImportError, match="SimDriver"):
        hw.RtlDriver(1e8, 1e6)
