"""The port's radio-facing apps against the JAX package's, ``main()`` of
both on the same files with ``--device cpu`` for the port:
``ax25_1200_rx`` (.au audio, raw c32, SigMF in its three forms, both clock
recoveries), ``bell202_tx``, ``capture``, ``rtl_fm -r sim``,
``scanner -r sim`` and ``soapy_fm -d sim``; and ``io.sigmf``.

The simulated SDR gives both packages the same samples bit for bit, so the
apps' outputs differ only by the filters' f32 rounding (the port's direct
FIR on the kernels' plain versions against the JAX package's XLA
convolution or overlap-save FFT): tolerances are stated per app.  Inputs
come from seeded numpy generators.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from rustradio_tpu.apps import ax25_1200_rx as jax25_1200_rx
from rustradio_tpu.apps import bell202_tx as jbell202_tx
from rustradio_tpu.apps import capture as jcapture
from rustradio_tpu.apps import rtl_fm as jrtl_fm
from rustradio_tpu.apps import scanner as jscanner
from rustradio_tpu.apps import soapy_fm as jsoapy_fm
from rustradio_tpu.io import au as jau
from rustradio_tpu.io import sigmf as jsigmf
from rustradio_tpu_torch.apps import (ax25_1200_rx, bell202_tx, capture, rtl_fm,
                                      scanner, soapy_fm)
from rustradio_tpu_torch.io import au, rawfile, sigmf
from test_models import make_afsk

PCM = 1 / 32767  # one step of the .au encoding
PAYLOADS = [b"N0CALL>APRS:first rx app frame", b"K1ABC>APRS:second frame, 0123",
            b"M0THC>APRS:the third and last frame"]


def _main(fn, args, capsys):
    assert fn(args) == 0
    return capsys.readouterr()


# ---- SigMF

@pytest.mark.parametrize("datatype", ["cf32_le", "ci16_le", "cu8", "ci8",
                                      "rf32_le", "ri16_le"])
def test_torch_sigmf_write_read_equal_jax(tmp_path, datatype):
    rng = np.random.RandomState(80)
    x = (0.5 * (rng.randn(1000) + 1j * rng.randn(1000))).clip(-0.99, 0.99)
    x = x.astype(np.complex64)
    if datatype.startswith("r"):
        x = x.real.copy()
    sigmf.write(str(tmp_path / "p"), x, 48_000.0, 145e6, datatype=datatype,
                author="port")
    jsigmf.write(str(tmp_path / "j"), x, 48_000.0, 145e6, datatype=datatype,
                 author="port")
    for suf in (".sigmf-meta", ".sigmf-data"):
        assert (tmp_path / f"p{suf}").read_bytes() == (tmp_path / f"j{suf}").read_bytes()
    got, meta = sigmf.read(str(tmp_path / "p.sigmf-data"))
    want, jmeta = jsigmf.read(str(tmp_path / "p"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sigmf.dump_meta(meta) == jsigmf.dump_meta(jmeta)
    assert meta.global_.author == "port" and meta.captures[0].frequency == 145e6


def test_torch_sigmf_tar_and_meta_equal_jax(tmp_path):
    doc = {"global": {"core:datatype": "cf32_le", "core:sample_rate": 50000,
                      "core:version": "1.0.0", "vendor:x": 3},
           "captures": [{"core:sample_start": 0, "core:frequency": 1e6,
                         "vendor:y": "z"}],
           "annotations": [{"core:sample_start": 10, "core:sample_count": 5,
                            "core:label": "burst"}]}
    text = json.dumps(doc)
    m, jm = sigmf.parse_meta(text), jsigmf.parse_meta(text)
    assert sigmf.dump_meta(m) == jsigmf.dump_meta(jm)
    assert m.global_.extra == {"vendor:x": 3} and m.annotations[0].label == "burst"
    x = np.arange(8, dtype=np.float32).view(np.complex64)
    path = str(tmp_path / "rec.sigmf")
    with tarfile.open(path, "w") as tf:
        for name, data in (("rec/rec.sigmf-meta", text.encode()),
                           ("rec/rec.sigmf-data", x.tobytes())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    got, meta = sigmf.read(path, sample_rate=25_000.0)
    want, _ = jsigmf.read(path, sample_rate=25_000.0)
    assert np.array_equal(got, want) and np.array_equal(got, x)
    assert meta.global_.sample_rate == 25_000.0
    with pytest.raises(ValueError, match="datatype"):
        sigmf._decode(b"\0" * 8, "cf128")


# ---- ax25_1200_rx

@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The three frames as 24 kHz .au audio and as a 50 kHz FM capture
    (raw c32, SigMF meta + data, SigMF tar; as
    tests/test_models_extra.py:51-62 modulates)."""
    d = tmp_path_factory.mktemp("rx")
    audio = np.concatenate([make_afsk(p, fs=24_000.0, lead_zeros=800)
                            for p in PAYLOADS])
    (d / "a.au").write_bytes(au.au_encode(audio, 24_000))
    fs = 50_000.0
    a50 = np.concatenate([make_afsk(p, fs=fs, lead_zeros=2000) for p in PAYLOADS])
    ph = np.cumsum(0.3 * a50.astype(np.float64) * (2 * np.pi * 3500.0 / fs))
    noise = np.random.RandomState(81).randn(2, len(ph)) * 0.01
    iq = (np.exp(1j * ph) + noise[0] + 1j * noise[1]).astype(np.complex64)
    rawfile.write_samples(str(d / "iq.c32"), iq)
    jsigmf.write(str(d / "iq"), iq, fs, 144.39e6)
    with tarfile.open(str(d / "iq.sigmf"), "w") as tf:
        for suf in (".sigmf-meta", ".sigmf-data"):
            tf.add(str(d / f"iq{suf}"), arcname=f"iq/iq{suf}")
    return d


def _written(out_dir):
    names = sorted(os.listdir(out_dir))
    return [n.rsplit(".", 1)[1] for n in names], \
        [open(os.path.join(out_dir, n), "rb").read() for n in names]


@pytest.mark.parametrize("mode", [
    "au", pytest.param("au events", marks=pytest.mark.slow),  # JAX's compile
    "au tones", "c32", "sigmf-meta", "sigmf-data", "sigmf-tar"])
def test_torch_ax25_1200_rx_main_equals_jax(captures, tmp_path, capsys, mode):
    d = captures
    args = {"au": ["-a", "-r", str(d / "a.au")],
            "c32": ["-r", str(d / "iq.c32"), "--sample_rate", "50k"],
            "sigmf-meta": ["-r", str(d / "iq.sigmf-meta")],
            "sigmf-data": ["-r", str(d / "iq.sigmf-data")],
            "sigmf-tar": ["-r", str(d / "iq.sigmf")]}[mode.split()[0]]
    if mode == "au events":
        args += ["--sync", "events"]
    if mode == "au tones":
        args += ["--demod", "tones"]
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    want = _main(jax25_1200_rx.main, args + ["-o", jout], capsys)
    got = _main(ax25_1200_rx.main, args + ["-o", pout, "--device", "cpu"], capsys)
    assert got.out == want.out
    assert got.out.count("\n") == 3 and "decoded 3 packets" in got.err
    assert _written(pout) == _written(jout)
    assert _written(pout)[1] == PAYLOADS


def test_torch_ax25_1200_rx_main_refusals(captures, tmp_path, capsys,
                                          monkeypatch):
    d = captures
    assert ax25_1200_rx.main(["-r", str(d / "iq.c32"), "--device", "cpu"]) == 1
    assert "requires --sample_rate" in capsys.readouterr().err
    meta = json.loads((d / "iq.sigmf-meta").read_text())
    del meta["global"]["core:sample_rate"]
    (tmp_path / "norate.sigmf-meta").write_text(json.dumps(meta))
    (tmp_path / "norate.sigmf-data").write_bytes((d / "iq.sigmf-data").read_bytes())
    assert ax25_1200_rx.main(["-r", str(tmp_path / "norate.sigmf-meta"),
                              "--device", "cpu"]) == 1
    assert "sample rate" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        ax25_1200_rx.main(["-a", "-r", str(d / "a.au")])
    assert "--device cpu" in capsys.readouterr().err


# ---- bell202_tx and capture

def test_torch_bell202_tx_main_equals_jax(tmp_path, capsys, monkeypatch):
    lines = "HELLO APP TEST\nSECOND LINE, 0123456789\nthird\n"
    outs = {}
    for name, fn, extra in (("j", jbell202_tx.main, []),
                            ("p", bell202_tx.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(lines))
        outs[name] = str(tmp_path / f"{name}.au")
        _main(fn, ["--src", "N0CALL-7", "--dst", "APRS", "--sample_rate", "24000",
                   "--out", outs[name]] + extra, capsys)
    got, rate = au.au_read(outs["p"])
    want, jrate = jau.au_read(outs["j"])
    # the same float64 phase sums (a sequential cumsum on both sides), sin
    # of numpy and of torch: at most one PCM step where a product lands on
    # a step's edge
    assert rate == jrate == 24_000 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PCM * 1.001, rtol=0)
    assert bell202_tx.make_ax25_ui("APRS", "N0CALL-7", b"x").tolist() == \
        jbell202_tx.make_ax25_ui("APRS", "N0CALL-7", b"x").tolist()
    out = _main(ax25_1200_rx.main, ["-a", "-r", outs["p"], "--device", "cpu"],
                capsys).out
    assert out.splitlines() == ["N0CALL-7>APRS: b'HELLO APP TEST'",
                                "N0CALL-7>APRS: b'SECOND LINE, 0123456789'",
                                "N0CALL-7>APRS: b'third'"]


def test_torch_capture_main_equals_jax(captures, tmp_path, capsys):
    args = ["-r", str(captures / "iq.c32"), "--sample_rate", "50k",
            "--frequency", "144.39m", "--author", "rx test"]
    _main(jcapture.main, args + ["--out", str(tmp_path / "j")], capsys)
    _main(capture.main, args + ["--out", str(tmp_path / "p")], capsys)
    for suf in (".sigmf-meta", ".sigmf-data"):
        assert (tmp_path / f"p{suf}").read_bytes() == (tmp_path / f"j{suf}").read_bytes()
    x, meta = sigmf.read(str(tmp_path / "p"))
    assert np.array_equal(x, rawfile.read_samples(str(captures / "iq.c32")))
    assert meta.global_.sample_rate == 50_000.0


# ---- the SDR apps on the simulated driver

SIM_FM = ["--sample_rate", "256k", "--audio_rate", "32k", "--cutoff", "25k",
          "--deviation", "10k", "--seconds", "0.25"]


@pytest.mark.parametrize("tones", [[], ["--sim_tone", "100.01M:0.6:1k:5k",
                                        "--sim_tone", "100.05M:0.3"]])
def test_torch_rtl_fm_sim_equals_jax(tmp_path, capsys, tones):
    jout, pout = str(tmp_path / "j.au"), str(tmp_path / "p.au")
    want_run = _main(jrtl_fm.main, ["-r", "sim", "--out", jout] + SIM_FM + tones,
                     capsys)
    got_run = _main(rtl_fm.main, ["-r", "sim", "--out", pout, "--device", "cpu"]
                    + SIM_FM + tones, capsys)
    # the same tags, in the same order
    assert [l for l in got_run.err.splitlines() if l.startswith("tag ")] == \
        [l for l in want_run.err.splitlines() if l.startswith("tag ")]
    got, _ = au.au_read(pout, 32_000)
    want, _ = jau.au_read(jout, 32_000)
    assert len(got) == len(want) == 8000
    # f32 direct FIR against the JAX package's overlap-save, then the exact
    # atan2 at gain 4.07: as tests/test_torch_fm_apps.py's c32 capture
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    spec = np.abs(np.fft.rfft(got[200:-200]))
    assert abs(np.argmax(spec[1:]) + 1 - 1000.0 * (len(got) - 400) / 32_000.0) <= 1


def test_torch_rtl_fm_sim_refuses_u8(tmp_path, capsys):
    with pytest.raises(SystemExit):
        rtl_fm.main(["-r", "sim", "--rtl_u8", "--out", str(tmp_path / "x.au"),
                     "--device", "cpu"])
    assert "capture files" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        rtl_fm.main(["-r", "rtl:x", "--out", str(tmp_path / "x.au"),
                     "--device", "cpu"])
    assert "bad rtl device spec" in capsys.readouterr().err


def test_torch_scanner_sim_equals_jax(capsys):
    args = ["-r", "sim", "--sample_rate", "2.048m", "-n", "256", "--top", "2",
            "--seconds", "0.05"]
    want = _main(jscanner.main, args, capsys).out
    got = _main(scanner.main, args + ["--device", "cpu"], capsys).out
    assert got == want
    # the two default tones: +0.2 MHz (channel 25) and -0.35 MHz (212)
    rows = [l.split() for l in got.splitlines()[1:]]
    assert [(r[0], r[1]) for r in rows] == [("25", "200.0k"), ("212", "-352.0k")]


def test_torch_soapy_fm_sim_equals_jax(tmp_path, capsys):
    args = ["-d", "sim", "--freq", "100M", "--sample_rate", "256k",
            "--audio_rate", "16k", "--seconds", "0.5"]
    jout, pout = str(tmp_path / "j.au"), str(tmp_path / "p.au")
    want_run = _main(jsoapy_fm.main, args + ["-o", jout], capsys)
    got_run = _main(soapy_fm.main, args + ["-o", pout, "--device", "cpu"], capsys)
    assert [l for l in got_run.err.splitlines() if l.startswith("tag ")] == \
        [l for l in want_run.err.splitlines() if l.startswith("tag ")]
    got, _ = au.au_read(pout, 16_000)
    want, _ = jau.au_read(jout, 16_000)
    assert len(got) == len(want) == 8000
    # tests/test_torch_fm_apps.py's wbfm_rx budget, 2e-3 of the audio's
    # scale, plus two PCM steps
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max() + 2 * PCM,
                               rtol=0)
    spec = np.abs(np.fft.rfft(got[1000:5096]))
    assert abs((np.argmax(spec[10:]) + 10) * 16_000 / 4096 - 1_000.0) < 50


def test_torch_soapy_fm_drivers(tmp_path, capsys):
    with pytest.raises(SystemExit):
        soapy_fm.main(["-d", "bogus", "-o", str(tmp_path / "x.au"), "--device",
                       "cpu"])
    assert "driver must be" in capsys.readouterr().err
    with pytest.raises(ImportError, match="SoapySDR"):
        soapy_fm.main(["-d", "soapy:driver=rtlsdr", "-o", str(tmp_path / "x.au"),
                       "--device", "cpu"])
