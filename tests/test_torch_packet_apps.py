"""The packet apps of the port against the JAX package's, end to end through
``main()`` on the same small files (tests/test_apps_main.py:106-160):
``g3ruh`` (KISS in -> baseband out, capture in -> KISS out),
``ax25_9600_rx``, ``ax25_9600_wpcr``, ``ax25_1200_wpcr`` and
``burst_saver``.  The port runs with ``--device cpu`` (the kernels' plain
versions), the JAX package on the CPU.  A comparison whose JAX receiver
takes 4 s or more to compile is marked slow; a port-only check of the same
app stays in the quick tier.
"""

import os

import numpy as np
import pytest
import torch

from rustradio_tpu.apps import ax25_1200_wpcr as jax25_1200_wpcr
from rustradio_tpu.apps import ax25_9600_rx as jax25_9600_rx
from rustradio_tpu.apps import ax25_9600_wpcr as jax25_9600_wpcr
from rustradio_tpu.apps import burst_saver as jburst_saver
from rustradio_tpu.apps import g3ruh as jg3ruh
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.apps import (
    ax25_1200_wpcr,
    ax25_9600_rx,
    ax25_9600_wpcr,
    burst_saver,
    g3ruh,
)
from rustradio_tpu_torch.io import rawfile
from test_models import make_afsk

CPU = ["--device", "cpu"]
PAYLOADS = [b"M0AAA>APRS:g3ruh app chain", b"M0BBB>APRS:second frame"]


def _packets(outdir):
    """The packet files an app wrote, in name order."""
    return [open(os.path.join(outdir, f), "rb").read()
            for f in sorted(os.listdir(outdir))]


@pytest.fixture(scope="module")
def kiss_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kiss") / "frames.kiss")
    with open(path, "wb") as f:
        for p in PAYLOADS:
            f.write(g3ruh.kiss_encode_frame(np.frombuffer(p, np.uint8)))
    return path


def _tx(mod, kiss_file, out, rate):
    args = ["--tx_in", kiss_file, "--tx_out", out, "--sample_rate", rate]
    assert mod.main(args + (CPU if mod is g3ruh else [])) == 0
    return rawfile.read_samples(out, "c32")


def _padded(iq, path, lead=20_000):
    z = np.zeros(lead, np.complex64)
    rawfile.write_samples(path, np.concatenate([z, iq, z]), "c32")
    return path


@pytest.mark.parametrize("rate", ["50k", "300k"])
def test_torch_g3ruh_tx_matches_jax(tmp_path, kiss_file, rate):
    # the same KISS frames, modulated by both packages: the same baseband
    # within the VCO's phase sums (float64 here, f32 in JAX) and the channel
    # filter (2e-5 of an envelope of ~0.57, tests/test_torch_g3ruh.py)
    got = _tx(g3ruh, kiss_file, str(tmp_path / "tx.c32"), rate)
    want = _tx(jg3ruh, kiss_file, str(tmp_path / "jtx.c32"), rate)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_torch_g3ruh_kiss_roundtrip():
    frames = [b"HELLO \xc0 WORLD \xdb!", b"SECOND FRAME"]
    stream = b"".join(g3ruh.kiss_encode_frame(np.frombuffer(f, np.uint8))
                      for f in frames)
    assert stream == b"".join(jg3ruh.kiss_encode_frame(np.frombuffer(f, np.uint8))
                              for f in frames)
    assert [bytes(f) for f in g3ruh.kiss_decode_stream(stream)] == frames


@pytest.fixture(scope="module")
def g3ruh_300k(tmp_path_factory, kiss_file):
    """Both frames from the port's TX at 300 kHz, padded with silence."""
    d = tmp_path_factory.mktemp("g3ruh")
    iq = _tx(g3ruh, kiss_file, str(d / "tx.c32"), "300k")
    return _padded(iq, str(d / "rx.c32"))


def test_torch_g3ruh_rx_writes_kiss(g3ruh_300k, capsysbinary):
    assert g3ruh.main(["-r", g3ruh_300k] + CPU) == 0
    out = capsysbinary.readouterr().out
    assert [bytes(f) for f in g3ruh.kiss_decode_stream(out)] == PAYLOADS
    assert g3ruh.main(["-r", g3ruh_300k, "--wpcr"] + CPU) == 0
    out = capsysbinary.readouterr().out
    assert [bytes(f) for f in g3ruh.kiss_decode_stream(out)] == PAYLOADS


def test_torch_ax25_9600_rx_app(tmp_path, g3ruh_300k):
    outdir = str(tmp_path / "pkts")
    assert ax25_9600_rx.main(["-r", g3ruh_300k, "-o", outdir] + CPU) == 0
    assert _packets(outdir) == PAYLOADS


def test_torch_ax25_9600_wpcr_app(tmp_path, kiss_file):
    # tests/test_apps_main.py:106: KISS -> TX at 50 kHz -> the WPCR app
    iq = _tx(g3ruh, kiss_file, str(tmp_path / "tx.c32"), "50k")
    rx = _padded(iq, str(tmp_path / "rx.c32"))
    outdir = str(tmp_path / "pkts")
    assert ax25_9600_wpcr.main(["-r", rx, "--sample_rate", "50k", "-o", outdir,
                                "--no_prewarm"] + CPU) == 0
    assert _packets(outdir) == PAYLOADS


@pytest.fixture(scope="module")
def afsk_50k(tmp_path_factory):
    """Two Bell-202 bursts FM-modulated at 50 kHz (test_models_extra.py:51)."""
    fs = 50_000.0
    parts = [np.zeros(4000, np.complex64)]
    for p in PAYLOADS:
        audio = make_afsk(p, fs=fs, lead_zeros=0)
        iq, _ = ops.vco(torch.from_numpy(audio * 0.3), k=2 * np.pi * 3500.0 / fs)
        parts += [np.conj(iq.numpy()), np.zeros(4000, np.complex64)]
    iq = np.concatenate(parts)
    iq = iq + (np.random.RandomState(7).randn(len(iq)) * 1e-4).astype(np.complex64)
    path = str(tmp_path_factory.mktemp("afsk") / "afsk.c32")
    rawfile.write_samples(path, iq, "c32")
    return path


def test_torch_ax25_1200_wpcr_app(tmp_path, afsk_50k):
    outdir = str(tmp_path / "pkts")
    assert ax25_1200_wpcr.main(["-r", afsk_50k, "-o", outdir, "--threshold",
                                "0.01", "--no_prewarm"] + CPU) == 0
    assert _packets(outdir) == PAYLOADS


def _burst_file(path):
    rng = np.random.RandomState(0)
    iq = np.zeros(60_000, np.complex64)
    iq[20_000:30_000] = (rng.randn(10_000) + 1j * rng.randn(10_000)).astype(
        np.complex64)
    iq[40_000:45_000] = 0.5
    rawfile.write_samples(path, iq, "c32")
    return path


def test_torch_burst_saver_matches_jax(tmp_path):
    # tests/test_apps_main.py:143: the same bursts cut by both packages
    path = _burst_file(str(tmp_path / "in.c32"))
    args = ["-r", path, "--sample_rate", "60k", "--threshold", "0.01",
            "--delay", "100", "--tail", "200"]
    got = []
    for mod, extra in ((burst_saver, CPU), (jburst_saver, [])):
        outdir = str(tmp_path / mod.__name__.split(".")[0])
        os.makedirs(outdir)
        assert mod.main(args + ["-o", outdir] + extra) == 0
        got.append([rawfile.read_samples(os.path.join(outdir, f), "c32")
                    for f in sorted(os.listdir(outdir))])
    assert len(got[0]) == len(got[1]) == 2
    for a, b in zip(*got):
        # the same cut; the 1446-tap channel filter in f32 by another
        # route (kernel A's plain version against the JAX package's): 1e-5
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_torch_extract_bursts():
    # tests/test_models_extra.py:113
    fs = 50_000.0
    rng = np.random.RandomState(3)
    quiet = (rng.randn(20_000) * 1e-5).astype(np.complex64)
    t = np.arange(12_000) / fs
    burst = (0.5 * np.exp(2j * np.pi * 1000.0 * t)).astype(np.complex64)
    iq = np.concatenate([quiet, burst, quiet])
    bursts = burst_saver.extract_bursts(iq, fs, new_rate=fs, threshold=0.01,
                                        delay=100, tail=200, device="cpu")
    assert len(bursts) == 1 and 11_000 < len(bursts[0]) < 14_000


@pytest.mark.slow
def test_torch_9600_apps_match_jax(tmp_path, g3ruh_300k, capsysbinary):
    # the same capture through both packages' 9600 bd apps: the same
    # packet files and the same KISS bytes
    for name, mod, jmod, args in (
            ("rx", ax25_9600_rx, jax25_9600_rx, []),
            ("wpcr", ax25_9600_wpcr, jax25_9600_wpcr,
             ["--sample_rate", "300k", "--no_prewarm"])):
        dirs = [str(tmp_path / f"{name}{k}") for k in (0, 1)]
        assert mod.main(["-r", g3ruh_300k, "-o", dirs[0]] + args + CPU) == 0
        assert jmod.main(["-r", g3ruh_300k, "-o", dirs[1]] + args) == 0
        assert _packets(dirs[0]) == _packets(dirs[1]) == PAYLOADS
    capsysbinary.readouterr()
    assert g3ruh.main(["-r", g3ruh_300k] + CPU) == 0
    got = capsysbinary.readouterr().out
    assert jg3ruh.main(["-r", g3ruh_300k]) == 0
    assert got == capsysbinary.readouterr().out


@pytest.mark.slow
def test_torch_ax25_1200_wpcr_app_matches_jax(tmp_path, afsk_50k):
    dirs = [str(tmp_path / f"p{k}") for k in (0, 1)]
    args = ["-r", afsk_50k, "--threshold", "0.01", "--no_prewarm"]
    assert ax25_1200_wpcr.main(args + ["-o", dirs[0]] + CPU) == 0
    assert jax25_1200_wpcr.main(args + ["-o", dirs[1]]) == 0
    assert _packets(dirs[0]) == _packets(dirs[1]) == PAYLOADS


def test_torch_packet_apps_need_a_card_or_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = _burst_file(str(tmp_path / "in.c32"))
    for mod, args in ((ax25_9600_rx, []), (ax25_1200_wpcr, ["--no_prewarm"]),
                      (ax25_9600_wpcr, ["--sample_rate", "60k"]),
                      (burst_saver, ["-o", str(tmp_path / "b")]), (g3ruh, [])):
        with pytest.raises(SystemExit):
            mod.main(["-r", path] + args)
        assert "--device cpu" in capsys.readouterr().err
