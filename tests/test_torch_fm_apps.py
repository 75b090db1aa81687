"""The port's FM family against the JAX package: the .au and rtl-sdr
codecs, the translating FIR, the single-pole IIR, the AM and WBFM
receivers, and the ``rtl_fm`` / ``am_decode`` apps end to end.

Inputs come from numpy RandomStates or closed forms; the JAX side runs on
the CPU (its composed ops), the port's on the kernels' plain versions.
"""

import jax
import numpy as np
import pytest
import torch

from rustradio_tpu import models as jmodels
from rustradio_tpu import ops as jops
from rustradio_tpu import taps as jtaps
from rustradio_tpu.apps import am_decode as jam_decode
from rustradio_tpu.apps import rtl_fm as jrtl_fm
from rustradio_tpu.io import au as jau
from rustradio_tpu.io import rawfile as jrawfile
from rustradio_tpu_torch import blocks, ops
from rustradio_tpu_torch.apps import am_decode, rtl_fm
from rustradio_tpu_torch.io import au, rawfile
from rustradio_tpu_torch.models import fm

PCM = 1 / 32767  # one step of the .au encoding


# ---- codecs: bit-equal

def test_torch_au_codec_equals_jax(tmp_path):
    rng = np.random.RandomState(70)
    x = np.clip(rng.randn(5000) * 0.4, -1, 1).astype(np.float32)
    x[:4] = [-1.0, 1.0, 0.0, -0.99999]
    raw = au.au_encode(x, 22050)
    assert raw == jau.au_encode(x, 22050)
    got, rate = au.au_decode(raw, 22050)
    want, jrate = jau.au_decode(raw, 22050)
    assert rate == jrate == 22050
    assert got.dtype == want.dtype and np.array_equal(got, want)
    path = tmp_path / "x.au"
    path.write_bytes(raw)
    assert np.array_equal(au.au_read(str(path))[0], want)
    for bad, msg in ((raw[:10], "too short"), (b"x" * 28, "magic")):
        with pytest.raises(ValueError, match=msg):
            au.au_decode(bad)
    with pytest.raises(ValueError, match="expected bitrate"):
        au.au_decode(raw, 8000)


def test_torch_rtlsdr_codec_equals_jax():
    rng = np.random.RandomState(71)
    iq = ((rng.randn(4096) + 1j * rng.randn(4096)) * 0.5).astype(np.complex64)
    u8 = rawfile.rtlsdr_encode(iq)
    assert u8.dtype == np.uint8
    assert np.array_equal(u8, np.asarray(jrawfile.rtlsdr_encode(iq)))
    back = rawfile.rtlsdr_decode(u8)
    assert back.dtype == np.complex64
    assert np.array_equal(back, np.asarray(jrawfile.rtlsdr_decode(u8)))


# ---- translating FIR

@pytest.mark.parametrize("freq,deci", [(6000.0, 2), (-11000.0, 3), (0.0, 2)])
def test_torch_fir_filter_translating(freq, deci):
    # tests/test_ops.py:55-67: against the explicitly mixed input (atol
    # 2e-3), and against the JAX op on the same input
    rng = np.random.RandomState(72)
    n, fs = 512, 48000.0
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    taps = jtaps.low_pass_complex(fs, 8000.0, 4000.0)
    got = ops.fir_filter_translating(torch.from_numpy(x), taps, fs, freq, deci)
    mixer = np.exp(-2j * np.pi * freq / fs * np.arange(n)).astype(np.complex64)
    want = ops.fir_filter(torch.from_numpy(x * mixer), taps, deci)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)
    jax_got = np.asarray(jops.fir_filter_translating(x, taps, fs, freq, deci))
    np.testing.assert_allclose(got.numpy(), jax_got, atol=2e-3)


def test_torch_fir_filter_translating_far_along_and_chunked():
    # the per-output rotator of a long stream (phases reduced mod 2*pi in
    # float64), and FirFilter(translate=) chunked == offline
    rng = np.random.RandomState(73)
    n, fs, freq, deci = 40_000, 48000.0, 7321.0, 3
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    taps = jtaps.low_pass_complex(fs, 8000.0, 4000.0)
    got = ops.fir_filter_translating(torch.from_numpy(x), taps, fs, freq, deci)
    want = np.asarray(jops.fir_filter_translating(x, taps, fs, freq, deci))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    blk = blocks.FirFilter(taps, deci=deci, translate=(fs, freq))
    st, parts = blk.init_state(), []
    for a in range(0, n, 7001):
        st, y = blk.apply_chunk(st, torch.from_numpy(x[a : a + 7001]))
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts).numpy(), got.numpy(), atol=2e-3)


# ---- single-pole IIR (tests/test_ops.py:196-206)

_jax_iir = jax.jit(jops.single_pole_iir, static_argnums=1)


def test_torch_single_pole_iir_golden():
    got = ops.single_pole_iir(torch.full((4,), 100.0), 0.9).numpy()
    np.testing.assert_allclose(got, [90.0, 99.0, 99.9, 99.99], rtol=1e-5)
    with pytest.raises(ValueError, match="out of"):
        ops.single_pole_iir(torch.ones(4), 1.5)


@pytest.mark.parametrize("n", [100, 5000])
def test_torch_single_pole_iir_continuation_and_jax(n):
    # the continuation at the reference's atol 1e-4, and the whole stream
    # against the JAX scan and a float64 loop (blocks of 128 and carries)
    x = np.random.RandomState(8).randn(n).astype(np.float32)
    xt = torch.from_numpy(x)
    full = ops.single_pole_iir(xt, 0.3).numpy()
    h = n // 2
    a = ops.single_pole_iir(xt[:h], 0.3)
    b = ops.single_pole_iir(xt[h:], 0.3, y0=a[-1])
    np.testing.assert_allclose(np.concatenate([a.numpy(), b.numpy()]), full,
                               atol=1e-4)
    np.testing.assert_allclose(full, np.asarray(_jax_iir(x, 0.3)), atol=1e-4)
    y, ref = 0.0, np.empty(n)
    for i, v in enumerate(x.astype(np.float64)):
        y = 0.3 * v + 0.7 * y
        ref[i] = y
    np.testing.assert_allclose(full, ref, atol=1e-5)
    xc = (x + 1j * x[::-1]).astype(np.complex64)
    np.testing.assert_allclose(ops.single_pole_iir(torch.from_numpy(xc), 0.2).numpy(),
                               np.asarray(_jax_iir(xc, 0.2)), atol=1e-4)


# ---- receivers

def _am_capture(rng, n, fs):
    t = np.arange(n) / fs
    env = 0.5 * (1 + 0.6 * np.sin(2 * np.pi * 700.0 * t))
    iq = env * np.exp(1j * (2 * np.pi * 2500.0 * t + 0.3))
    return (iq + 0.01 * (rng.randn(n) + 1j * rng.randn(n))).astype(np.complex64)


def test_torch_am_rx_matches_jax():
    rng = np.random.RandomState(74)
    fs = 96_000.0
    iq = _am_capture(rng, 1 << 15, fs)
    got = fm.am_rx(iq, fs, 12_000.0, 0.8, device="cpu")
    want = np.asarray(jmodels.am_rx(iq, fs, 12_000.0, 0.8))
    assert got.shape == want.shape
    # f32 direct FIR (port) against f32 overlap-save (JAX), then |.|:
    # 1e-5 of the audio's scale
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="device="):
        fm.am_rx(iq, fs)


def test_torch_wbfm_rx_matches_jax():
    rng = np.random.RandomState(75)
    fs, n = 480_000.0, 1 << 15
    t = np.arange(n) / fs
    ph = 2 * np.pi * 75_000.0 * np.cumsum(0.5 * np.sin(2 * np.pi * 1000.0 * t)) / fs
    iq = (np.exp(1j * ph) + 0.02 * (rng.randn(n) + 1j * rng.randn(n))
          ).astype(np.complex64)
    got = fm.wbfm_rx(torch.from_numpy(iq), fs)
    want = np.asarray(jmodels.wbfm_rx(iq, fs))
    assert got.shape == want.shape
    # exact atan2 on both; the filters differ by f32 rounding (direct FIR
    # against overlap-save), the de-emphasis by the scan's order: 2e-3 of
    # the audio's scale, the reference streaming-chain budget
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * np.abs(want).max())
    # the 1 kHz tone comes out (the de-emphasis turns its phase)
    spec = np.abs(np.fft.rfft(got.numpy()[200:-200]))
    assert abs(np.argmax(spec[1:]) + 1 - 1000.0 * (len(got) - 400) / 48_000.0) <= 1


# ---- the apps end to end, on the captures of tests/test_apps_main.py

@pytest.fixture(scope="module")
def fm_captures(tmp_path_factory):
    # tests/test_apps_main.py:191: 2^16 samples at 256 kHz, 1 kHz tone at
    # 10 kHz deviation, written as u8 and as c32
    d = tmp_path_factory.mktemp("fm")
    fs, n = 256_000.0, 1 << 16
    t = np.arange(n) / fs
    ph = 2 * np.pi * 10_000.0 * np.cumsum(np.sin(2 * np.pi * 1000.0 * t)) / fs
    iq = (0.6 * np.exp(1j * ph)).astype(np.complex64)
    rawfile.rtlsdr_encode(iq).tofile(d / "cap.u8")
    iq.tofile(d / "cap.c32")
    return d


RTL_ARGS = ["--sample_rate", "256k", "--audio_rate", "32k", "--cutoff", "25k",
            "--deviation", "10k"]
GAIN = 256_000.0 / (2 * np.pi * 10_000.0)


@pytest.mark.parametrize("mode", ["c32", "w3", "i8"])
def test_torch_rtl_fm_main_matches_jax(fm_captures, tmp_path, mode):
    d = fm_captures
    if mode == "c32":
        args = ["-r", str(d / "cap.c32")]
        # f32 direct FIR against f32 overlap-save, then the exact atan2 at
        # gain 4.07: the reference's translating-FIR budget, 2e-3
        tol = 2e-3
    else:
        args = ["-r", str(d / "cap.u8"), "--rtl_u8", "--precision", mode]
        # kernel B's budget against the JAX package's composed fallback
        # (3e-4 rad, fast atan2) times the gain, plus two PCM steps
        tol = 3e-4 * GAIN + 2 * PCM
    jout, pout = str(tmp_path / "j.au"), str(tmp_path / "p.au")
    assert jrtl_fm.main(args + ["--out", jout] + RTL_ARGS) == 0
    assert rtl_fm.main(args + ["--out", pout, "--device", "cpu"] + RTL_ARGS) == 0
    want, _ = jau.au_read(jout, 32_000)
    got, _ = au.au_read(pout, 32_000)
    assert len(got) == len(want) == 8192
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the 1 kHz tone comes out
    spec = np.abs(np.fft.rfft(got[200:-200]))
    assert abs(np.argmax(spec[1:]) + 1 - 1000.0 * (len(got) - 400) / 32_000.0) <= 1


@pytest.mark.parametrize("read", ["sim", "rtl", "rtl:1"])
def test_torch_rtl_fm_live_sources_name_hw(tmp_path, capsys, read):
    # the live sources run through hw/: the simulated driver gives audio;
    # a live RTL-SDR needs pyrtlsdr, absent here, and says so
    args = ["-r", read, "--out", str(tmp_path / "x.au"), "--device", "cpu"]
    if read == "sim":
        assert rtl_fm.main(args + ["--seconds", "0.05"]) == 0
        assert "tag SdrSource::driver = sim" in capsys.readouterr().err
        assert len(au.au_read(str(tmp_path / "x.au"))[0]) == 2400
        return
    with pytest.raises(ImportError, match="pyrtlsdr not available.*hw.SimDriver"):
        rtl_fm.main(args)


def test_torch_rtl_fm_without_a_card_names_cpu(fm_captures, tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        rtl_fm.main(["-r", str(fm_captures / "cap.c32"), "--out",
                     str(tmp_path / "x.au")] + RTL_ARGS)
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("fmt,ext", [("c32", "f32"), ("c32", "au"),
                                     ("airspy", "f32")])
def test_torch_am_decode_main_matches_jax(tmp_path, fmt, ext):
    rng = np.random.RandomState(76)
    fs = 96_000.0
    iq = _am_capture(rng, 1 << 15, fs)
    path = tmp_path / "cap.raw"
    if fmt == "airspy":
        q = np.round(np.stack([iq.real, iq.imag]) * 1000.0).astype(np.int16)
        (q[0].view(np.uint16).astype(np.uint32)
         | (q[1].view(np.uint16).astype(np.uint32) << 16)).tofile(path)
        assert np.array_equal(am_decode.airspy_decode(np.fromfile(path, np.uint32)),
                              jam_decode.airspy_decode(np.fromfile(path, np.uint32)))
    else:
        iq.tofile(path)
    args = ["-r", str(path), "-f", fmt, "--sample_rate", "96k",
            "--audio_rate", "12k"]
    jout, pout = str(tmp_path / f"j.{ext}"), str(tmp_path / f"p.{ext}")
    assert jam_decode.main(args + ["-o", jout]) == 0
    assert am_decode.main(args + ["-o", pout, "--device", "cpu"]) == 0
    if ext == "au":
        want, got = jau.au_read(jout)[0], au.au_read(pout)[0]
        tol = 1e-5 + 2 * PCM
    else:
        want, got = np.fromfile(jout, "<f4"), np.fromfile(pout, "<f4")
        tol = 1e-5
    assert len(got) == len(want) == 4096
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
