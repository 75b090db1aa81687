"""The generator apps and the spectrum viewer of the port against the JAX
package's, each ``main()`` run on the same arguments and inputs: ``tone``
(c32 and ``--real``), ``fm_tx``, ``morse_beacon`` (c32 and .au),
``spectrum`` (raw c32 and SigMF) and ``pw_tone --backend file``.  The
port's apps run with ``--device cpu`` (the card is their default).
Tolerances: 1e-6 absolute for the sines (f32 phases, sin and cos by two
libraries), one PCM step for .au output, and the VCO's of
tests/test_torch_g3ruh.py (the port sums its phase in float64).
"""

import numpy as np
import pytest

from rustradio_tpu.apps import fm_tx as jfm_tx
from rustradio_tpu.apps import morse_beacon as jmorse_beacon
from rustradio_tpu.apps import pw_tone as jpw_tone
from rustradio_tpu.apps import spectrum as jspectrum
from rustradio_tpu.apps import tone as jtone
from rustradio_tpu_torch.apps import fm_tx, morse_beacon, pw_tone, spectrum, tone
from rustradio_tpu_torch.io import au, rawfile, sigmf

PCM = 1 / 32767  # one step of the .au encoding


def _both(port_main, jax_main, args, tmp_path, out_name):
    """Run both apps, each writing its own ``out_name``; return the two
    paths."""
    paths = []
    for name, main, extra in (("port", port_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        out = str(tmp_path / f"{name}_{out_name}")
        assert main(args + ["--out", out] + extra) == 0
        paths.append(out)
    return paths


@pytest.mark.parametrize("real", [False, True])
def test_torch_tone_app_equals_jax(tmp_path, real):
    args = ["--freq", "1.5k", "--sample_rate", "48k", "--seconds", "0.25",
            "--amplitude", "0.7"] + (["--real"] if real else [])
    name = "t.f32" if real else "t.c32"
    got, want = (rawfile.read_samples(p, "f32" if real else "c32")
                 for p in _both(tone.main, jtone.main, args, tmp_path, name))
    assert got.shape == want.shape == (12_000,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_torch_fm_tx_app_equals_jax(tmp_path):
    t = np.arange(8000) / 8000.0
    audio = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    src = tmp_path / "a.au"
    src.write_bytes(au.au_encode(audio, 8000))
    args = ["-r", str(src), "--sample_rate", "48k", "--deviation", "5k"]
    got, want = (rawfile.read_samples(p, "c32")
                 for p in _both(fm_tx.main, jfm_tx.main, args, tmp_path, "f.c32"))
    assert got.shape == want.shape == (48_000,)
    # the VCO's phase: the JAX package sums it in f32 (~1e-4 rad at the
    # ~3000 rad it reaches here), the port in float64
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    # the port's against a float64 model of the modulation
    up = np.repeat(au.au_read(str(src))[0].astype(np.float64), 6)
    k = np.float64(np.float32(2 * np.pi * 5000.0 / 48_000.0))
    ph = np.mod(np.cumsum(up * k), 2 * np.pi)
    np.testing.assert_allclose(got, np.sin(ph) + 1j * np.cos(ph), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ext", ["c32", "au"])
def test_torch_morse_beacon_app_equals_jax(tmp_path, ext):
    args = ["--msg", "CQ DE N0CALL", "--wpm", "30", "--sample_rate", "8k",
            "--tone", "700"]
    port, jax = _both(morse_beacon.main, jmorse_beacon.main, args, tmp_path,
                      f"m.{ext}")
    if ext == "au":
        got, want = au.au_read(port)[0], au.au_read(jax)[0]
        np.testing.assert_allclose(got, want, atol=PCM, rtol=0)
    else:
        got, want = rawfile.read_samples(port, "c32"), rawfile.read_samples(jax, "c32")
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        # the envelope is the keying
        from rustradio_tpu_torch.blocks import morse_encode_bits

        key = np.repeat(morse_encode_bits("CQ DE N0CALL"), int(8000 * 1.2 / 30))
        assert np.array_equal(np.abs(got) > 0.5, key == 1)


def _spectrum_out(main, args, capsys):
    assert main(args) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("form", ["c32", "sigmf"])
def test_torch_spectrum_app_equals_jax(tmp_path, capsys, form):
    rng = np.random.RandomState(9)
    n = 1 << 15
    t = np.arange(n)
    x = (np.exp(2j * np.pi * 0.2 * t) + 0.05 * (rng.randn(n) + 1j * rng.randn(n))
         ).astype(np.complex64)
    if form == "c32":
        path = str(tmp_path / "x.c32")
        rawfile.write_samples(path, x)
    else:
        path = str(tmp_path / "x")
        sigmf.write(path, x, 250_000.0)
        path += ".sigmf-meta"
    args = ["-r", path, "--sample_rate", "250k", "--fft_size", "256",
            "--width", "64", "--height", "16"]
    got = _spectrum_out(spectrum.main, args + ["--device", "cpu"], capsys)
    want = _spectrum_out(jspectrum.main, args, capsys)
    assert got[-1] == want[-1] == "span: -125 kHz ... +125 kHz, 0.13 s, 128 frames"
    # the waterfall: the same characters where the dB values sit off the
    # ramp's steps (two FFT libraries; at most 1% of the cells differ)
    cells = sum(len(r) for r in want[:-1])
    diff = sum(a != b for r, s in zip(got[:-1], want[:-1]) for a, b in zip(r, s))
    assert len(got) == len(want) == 17 and diff <= cells // 100
    # the station's column is the brightest
    col = [r.index("@") for r in got[:-1] if "@" in r]
    assert col and all(abs(c - col[0]) <= 1 for c in col)


def test_torch_pw_tone_file_backend_equals_jax(tmp_path):
    args = ["--freq", "1k", "--seconds", "0.5", "--audio_rate", "16k",
            "--volume", "0.3", "--backend", "file"]
    got, want = (np.fromfile(p, "<f4") for p in
                 _both(pw_tone.main, jpw_tone.main, args, tmp_path, "t.f32"))
    assert got.shape == want.shape == (8000,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    t = np.arange(1, 8001) * 2 * np.pi * 1000 / 16000
    np.testing.assert_allclose(got, 0.3 * np.sin(t), atol=1e-6, rtol=0)
