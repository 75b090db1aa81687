"""Parity of the AX.25 receiver's ops in the port with the JAX package:
tap designs, the FFT filters and their dispatch, Hilbert, the resampler,
NRZI, the slicer, HDLC and CRC, clock recovery, and the native library.

Every input is made with numpy from a fixed RandomState and fed to both
packages; JAX runs on the CPU.  On CPU tensors the port's kernel wrappers
run their plain PyTorch versions.
"""

import subprocess

import numpy as np
import pytest
import torch

import rustradio_tpu.ops as jops
from rustradio_tpu import native as jnative
from rustradio_tpu import taps as jtaps
from rustradio_tpu.ops.fft_filter import fft_filter_decimate as jfft_decimate
from rustradio_tpu.ops import hdlc as jhdlc
from rustradio_tpu_torch import _buildcache, native, ops, taps
from rustradio_tpu_torch.ops import hdlc
from test_pallas_interpret import _fir_deci_f64

# the JAX package's FIR budget (test_pallas_interpret.py:45): 2e-5 * max|y|
FIR_BUDGET = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, budget=FIR_BUDGET):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=budget * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("design", ["band_pass", "hilbert", "low_pass"])
def test_torch_tap_designs_equal_jax(design):
    args = {"band_pass": (24e3, 400.0, 2700.0, 65), "hilbert": (65,),
            "low_pass": (24e3, 1100.0, 200.0)}[design]
    got = getattr(taps, design)(*args)
    want = getattr(jtaps, design)(*args)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ntaps", [65, 5000])
def test_torch_filter_float_matches_jax(ntaps):
    # 65 taps run on fir_decimate, 5000 on the overlap-save FFT route
    rng = np.random.RandomState(70 + ntaps)
    x = rng.randn(12_000).astype(np.float32)
    t = rng.randn(ntaps).astype(np.float32)
    got = ops.filter_float(_t(x), t).numpy()
    _close(got, jops.filter_float(x, t))
    _close(got, _fir_deci_f64(x, t, 1))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_torch_filter_complex_matches_jax(kind):
    # real-valued complex taps (a low_pass_complex design) take two real
    # fir_decimate passes; truly complex taps take the FFT route
    rng = np.random.RandomState(72)
    x = (rng.randn(9000) + 1j * rng.randn(9000)).astype(np.complex64)
    t = rng.randn(301).astype(np.complex64)
    if kind == "complex":
        t = (t + 1j * rng.randn(301)).astype(np.complex64)
    got = ops.filter_complex(_t(x), t).numpy()
    _close(got, jops.filter_complex(x, t))
    want = np.convolve(x.astype(np.complex128), t.astype(np.complex128))[:9000]
    _close(got, want)


def test_torch_fft_filters_match_jax():
    rng = np.random.RandomState(73)
    x = (rng.randn(20_000) + 1j * rng.randn(20_000)).astype(np.complex64)
    t = rng.randn(257).astype(np.float32)
    full = np.convolve(x.astype(np.complex128), t.astype(np.float64))[:20_000]
    got = ops.fft_filter(_t(x), t).numpy()
    _close(got, jops.fft_filter(x, t))
    _close(got, full)
    got = ops.fft_filter_decimate(_t(x), t, 4).numpy()
    _close(got, jfft_decimate(x, t, 4))
    _close(got, full[::4])
    got = ops.fft_filter_float(_t(x.real), t, fft_size=1024).numpy()
    _close(got, jops.fft_filter_float(x.real, t, fft_size=1024))
    _close(got, np.convolve(x.real.astype(np.float64), t)[:20_000])


def test_torch_hilbert_transform_matches_jax():
    rng = np.random.RandomState(74)
    x = rng.randn(7000).astype(np.float32)
    got = ops.hilbert_transform(_t(x), 65).numpy()
    want = np.asarray(jops.hilbert_transform(x, 65))
    _close(got.real, want.real, 0.0)  # a pure delay
    _close(got.imag, want.imag)


@pytest.mark.parametrize("interp,deci", [(1, 1), (25, 512), (3, 64), (4, 1)])
@pytest.mark.parametrize("cplx", [False, True])
def test_torch_rational_resampler_equals_jax(interp, deci, cplx):
    rng = np.random.RandomState(75)
    x = rng.randn(5003).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.randn(5003)).astype(np.complex64)
    got = ops.rational_resampler(_t(x), interp, deci).numpy()
    assert np.array_equal(got, np.asarray(jops.rational_resampler(x, interp, deci)))
    assert np.array_equal(ops.resampler_indices(5003, interp, deci),
                          jops.resampler_indices(5003, interp, deci))


def test_torch_nrzi_and_slicer_equal_jax():
    rng = np.random.RandomState(76)
    bits = rng.randint(0, 2, 4001).astype(np.uint8)
    soft = rng.randn(4001).astype(np.float32)
    soft[:3] = [0.0, -0.0, 1e-30]
    for last in (0, 1):
        assert np.array_equal(ops.nrzi_decode(_t(bits), last).numpy(),
                              np.asarray(jops.nrzi_decode(bits, last)))
        assert np.array_equal(ops.nrzi_encode(_t(bits), last).numpy(),
                              np.asarray(jops.nrzi_encode(bits, last)))
    assert np.array_equal(ops.binary_slicer(_t(soft)).numpy(),
                          np.asarray(jops.binary_slicer(soft)))
    assert ops.nrzi_decode(torch.zeros(0, dtype=torch.uint8)).shape == (0,)


def test_torch_crc_and_framing_equal_jax():
    rng = np.random.RandomState(77)
    for n in (0, 1, 17, 300):
        data = rng.randint(0, 256, n).astype(np.uint8)
        assert ops.calc_crc(data) == jops.calc_crc(data)
        assert np.array_equal(ops.fcs_add(data), jops.fcs_add(data))
        # all-ones bytes exercise the bit stuffing
        data[: n // 2] = 0xFF
        assert np.array_equal(ops.hdlc_frame(data), jops.hdlc_frame(data))
        assert np.array_equal(ops.hdlc_frame(data, 3), jops.hdlc_frame(data, 3))


def _bit_stream(rng, n_frames):
    """Framed random payloads between noise bits, some with a flipped bit."""
    parts = []
    for i in range(n_frames):
        data = rng.randint(0, 256, 12 + 7 * i).astype(np.uint8)
        f = ops.hdlc_frame(ops.fcs_add(data), 2)
        if i % 3 == 2:
            f = f.copy()
            f[40] ^= 1
        parts += [rng.randint(0, 2, 50).astype(np.uint8), f]
    return np.concatenate(parts)


@pytest.mark.parametrize("fix_bits", [False, True])
@pytest.mark.parametrize("keep_checksum", [False, True])
def test_torch_hdlc_deframe_native_and_python_equal_jax(fix_bits,
                                                        keep_checksum):
    bits = _bit_stream(np.random.RandomState(78), 9)
    kw = dict(min_size=5, max_size=1500, keep_checksum=keep_checksum,
              fix_bits=fix_bits)
    want, want_stats = jhdlc.hdlc_deframe(bits, **kw)
    want_py = jhdlc.HdlcStateMachine(**kw)
    want_py_packets = want_py.feed(bits)
    got, stats = ops.hdlc_deframe(_t(bits), **kw)  # native
    py = hdlc.HdlcStateMachine(**kw)
    got_py = py.feed(bits)
    for packets in (got, got_py, want_py_packets):
        assert [(bytes(d), p) for d, p in packets] == [
            (bytes(d), p) for d, p in want]
    assert stats == want_stats == py.stats == want_py.stats
    assert stats["decoded"] >= 6


def test_torch_recover_symbols_bit_equal_jax():
    rng = np.random.RandomState(79)
    sps = 20.0 * 1.01
    line = np.repeat(rng.randint(0, 2, 800) * 2.0 - 1.0, 20)
    x = (np.convolve(line, np.ones(7) / 7, "same")
         + 0.3 * rng.randn(len(line))).astype(np.float32)
    taps6 = (1 / 6,) * 6
    got = ops.recover_symbols(_t(x), sps, 0.5, taps6)
    want = jops.recover_symbols(x, sps, 0.5, taps6)
    assert got.dtype == np.float32 and len(got) > 700
    assert np.array_equal(got, want)


def test_torch_native_builds_into_the_port(tmp_path, monkeypatch):
    # the port's library lives in its own _build/, named by source + flags
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "rustradio_tpu_torch"
    assert path.name.startswith("librr_native_") and path.suffix == ".so"
    assert native.SOURCE.resolve() == (native.PKG_DIR.parent / "native"
                                       / "rr_native.cpp").resolve()
    assert "-ffp-contract=off" in native.CXX_FLAGS
    # a fresh build writes only inside the build directory: a temp file,
    # then an atomic replace; never the JAX package's native/librr_native.so
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    cmds = []
    real_run = subprocess.run

    def spy(cmd, **kw):
        cmds.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(_buildcache.subprocess, "run", spy)
    out = native.build()
    assert out.parent == tmp_path / "_build" and out.exists()
    assert len(cmds) == 1
    target = cmds[0][cmds[0].index("-o") + 1]
    assert target.startswith(str(tmp_path / "_build"))
    assert target != jnative._SO
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [out.name]
    assert native.build() == out and len(cmds) == 1  # a cache hit


def test_torch_native_build_failure_names_the_command(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cpp"):
        native.build()
    assert list(tmp_path.iterdir()) == [tmp_path / "broken.cpp"]


def test_torch_native_library_named_by_host_target(monkeypatch):
    # a library compiled with -march=native on one CPU is not loaded on
    # another: the name hashes what g++ resolves the flags to on this host
    assert "-march=" in native.host_target()
    here = native.library_path()
    monkeypatch.setattr(native, "host_target", lambda: "-march=\tother")
    assert native.library_path() != here
    assert native.library_path().parent == here.parent


def test_torch_hdlc_deframe_raises_without_native(monkeypatch):
    # no silent switch to the Python deframer: a broken build is loud
    def broken():
        raise RuntimeError("g++ failed (exit 1): g++ ... rr_native.cpp")

    monkeypatch.setattr(native, "_LIBRARY",
                        _buildcache.Library(broken, native._bind))
    bits = _bit_stream(np.random.RandomState(80), 2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ops.hdlc_deframe(bits)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()  # remembered
    assert hdlc.HdlcStateMachine().feed(bits)  # the reference still runs
