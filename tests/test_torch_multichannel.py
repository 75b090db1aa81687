"""The port's wideband receiver (parallel.channelizer, models.multichannel,
apps.scanner) against the JAX package's on the same numpy inputs, JAX on
the CPU.

The captures are those of tests/test_multichannel.py: Bell-202 AFSK at
32 kHz, held up to the RF rate (the integer-ratio rational resampler is a
sample-and-hold, so numpy's repeat makes the same samples), frequency
modulated at 3 kHz deviation onto channel centers of a 512 kHz capture.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from rustradio_tpu.apps import scanner as jscanner
from rustradio_tpu.models import multichannel as jmc
from rustradio_tpu.parallel import channelizer as jch
from rustradio_tpu_torch import ops, taps
from rustradio_tpu_torch.apps import scanner
from rustradio_tpu_torch.io import rawfile
from rustradio_tpu_torch.models import multichannel
from rustradio_tpu_torch.parallel import channelizer
from test_torch_ax25 import _erode

FS = 512_000.0
FS_AUDIO = 32_000.0
M = 16  # 32 kHz channels, ~26.7 samples/symbol
STATIONS = {
    2: b"STATION A>APRS:chan 2",
    5: b"STATION B>APRS:chan 5",
    11: b"STATION C>APRS:chan 11",  # negative-frequency side (11-16)*fs/M
}


def _afsk_audio(payload: bytes, baud=1200.0, amp=0.8, lead=400):
    framed = ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8)))
    line = (1 + np.cumsum(1 - framed)) % 2
    sps = FS_AUDIO / baud
    n = int(len(line) * sps)
    bit_at = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
    phase = np.cumsum(2 * np.pi * np.where(line[bit_at] == 1, 1200.0, 2200.0)
                      / FS_AUDIO)
    z = np.zeros(lead, np.float32)
    return np.concatenate([z, (amp * np.sin(phase)).astype(np.float32), z])


def _fm_upconvert(audio, f_center, deviation=3_000.0):
    up = np.repeat(audio, int(FS // FS_AUDIO))
    phase = 2 * np.pi * np.cumsum(deviation * up) / FS
    t = np.arange(len(up)) / FS
    return np.exp(1j * (phase + 2 * np.pi * f_center * t)).astype(np.complex64)


def _chan_freq(k):
    return (k if k < M / 2 else k - M) * FS / M


@pytest.fixture(scope="module")
def band():
    """The three stations of tests/test_multichannel.py:232-259."""
    parts = [_fm_upconvert(_afsk_audio(p), _chan_freq(k))
             for k, p in STATIONS.items()]
    wide = np.zeros(max(map(len, parts)) + 4096, np.complex64)
    for iq in parts:
        wide[: len(iq)] += iq
    rng = np.random.RandomState(1)
    wide += (rng.randn(len(wide)) + 1j * rng.randn(len(wide))).astype(
        np.complex64) * 0.01
    return wide


@pytest.fixture(scope="module")
def one_station(tmp_path_factory):
    """tests/test_multichannel.py:279-291's capture, written as .c32."""
    iq = _fm_upconvert(_afsk_audio(b"CLI>APRS:scan decode"), 2 * FS / M)
    wide = np.concatenate([iq, np.zeros(4096, np.complex64)])
    path = str(tmp_path_factory.mktemp("scan") / "band.c32")
    rawfile.write_samples(path, wide, "c32")
    return path, wide


# ---- channelizer

@pytest.mark.parametrize("m", [16, 64, 256])
def test_torch_channelizer_taps_bit_equal(m):
    got = channelizer.channelizer_taps(m, 8)
    want = jch.channelizer_taps(m, 8)
    assert got.dtype == np.float32 and got.shape == (8 * m,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [16, 64])
def test_torch_pfb_channelize_matches_jax(m):
    rng = np.random.RandomState(m)
    n = m * 300 + 5
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    h = jch.channelizer_taps(m, 8)
    want = np.asarray(jax.jit(lambda v: jch.pfb_channelize(v, h, m))(x))
    got = channelizer.pfb_channelize(x, h, m, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape == (300, m)
    # f32 FMAs of the branch FIR, then two FFT libraries
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_torch_channelizer_fm_bank_matches_jax(band):
    x = band[: 1 << 15]
    h = jch.channelizer_taps(M, 8)
    want = np.asarray(jax.jit(lambda v: jch.channelizer_fm_bank(v, h, M, 0.5))(x))
    got = channelizer.channelizer_fm_bank(torch.from_numpy(x), h, M, 0.5).numpy()
    assert got.shape == want.shape == ((1 << 15) // M - 1, M)
    # the exact atan2, compared (wrapped) where the channel is alive: both
    # samples above 1e-3 of the channelizer output's maximum.  The IFFT's
    # rounding scales with a frame's total over all channels, so on the
    # noise-only channels (max ~0.08 against the stations' 1.06) samples
    # near 1e-3 of their own maximum move by up to 2.2e-4 rad
    mag = np.abs(channelizer.pfb_channelize(torch.from_numpy(x), h, M).numpy())
    live = np.minimum(mag[:-1], mag[1:]) > 1e-3 * mag.max()
    assert live[:, list(STATIONS)].mean() > 0.99 and live.mean() > 0.8
    d = (got - want + 0.5 * np.pi) % np.pi - 0.5 * np.pi
    assert np.abs(d[live]).max() <= 1e-4


# ---- the receiver

@pytest.mark.parametrize("sync", ["scan", "events"])
def test_torch_decode_band_three_stations(band, sync):
    results = multichannel.decode_band_ax25(band, FS, n_channels=M,
                                            max_active=6, sync_method=sync,
                                            device="cpu")
    got = {r.channel: [bytes(p) for p in r.packets] for r in results}
    assert set(got) == set(STATIONS)
    for k, payload in STATIONS.items():
        assert got[k] == [payload]
    assert {r.channel: r.freq for r in results} == {k: _chan_freq(k)
                                                    for k in STATIONS}


def test_torch_bank_demod_matches_jax(band):
    # one channel's NRZ from the same channelized samples, compared where
    # the analytic signal is alive (as tests/test_torch_ax25.py does)
    h = jch.channelizer_taps(M, 8)
    ch = channelizer.pfb_channelize(band, h, M, device="cpu")
    rate = FS / M
    got = multichannel._bank_demod(ch, [5], rate)[0].numpy()
    want = np.asarray(jmc._bank_demod(ch.numpy(), jax.numpy.asarray([5]), rate))[0]
    assert got.shape == want.shape == (ch.shape[0] - 2,)
    col = ch[:, 5]
    fm = torch.atan2((torch.conj(col[:-1]) * col[1:]).imag,
                     (torch.conj(col[:-1]) * col[1:]).real)
    bp = ops.filter_float(fm, taps.band_pass(rate, 400.0, 2700.0, 65))
    mag = np.abs(ops.hilbert_transform(bp, 65).numpy())
    live = np.minimum(mag[:-1], mag[1:]) > 1e-3 * mag.max()
    inner = _erode(live, len(taps.low_pass(rate, 1100.0, 200.0)))
    assert inner.mean() > 0.5
    np.testing.assert_allclose(got[inner], want[inner], atol=1e-4, rtol=0)


def test_torch_decode_band_checks_its_arguments():
    with pytest.raises(ValueError, match="use fewer channels"):
        multichannel.decode_band_ax25(np.zeros(1024, np.complex64), 48_000.0,
                                      n_channels=64, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        multichannel.decode_band_ax25(np.zeros(1024, np.complex64), FS,
                                      sync_method="event", device="cpu")
    with pytest.raises(ValueError, match="needs device="):
        multichannel.decode_band_ax25(np.zeros(1024, np.complex64), FS)


# ---- the scanner app

def test_torch_scanner_table_and_demod_match_jax(one_station, tmp_path, capsys):
    path, _ = one_station
    args = ["-r", path, "--sample_rate", "512k", "-n", "16", "--top", "5",
            "--demod", "2"]
    assert jscanner.main(args + ["--out", str(tmp_path / "j.f32")]) == 0
    want = capsys.readouterr().out
    assert scanner.main(args + ["--out", str(tmp_path / "t.f32"),
                                "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want
    assert got.out.splitlines()[1].split()[0] == "2"
    assert "channel 2" in got.err
    a = rawfile.read_samples(str(tmp_path / "t.f32"), "f32")
    b = rawfile.read_samples(str(tmp_path / "j.f32"), "f32")
    assert a.shape == b.shape
    d = (a - b + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-4


@pytest.mark.parametrize("sync", ["scan", "events"])
def test_torch_scanner_decodes(one_station, capsys, sync):
    path, _ = one_station
    assert scanner.main(["-r", path, "--sample_rate", "512k", "-n", "16",
                         "--decode", "--max_active", "4", "--sync", sync,
                         "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    # the payload is raw ASCII, not an AX.25 address block, so only the
    # channel line is stable
    assert cap.out.startswith("ch   2     +64.0k")
    assert "decoded 1 packets on 1 channels" in cap.err


def test_torch_scanner_refuses_sim_and_missing_card(one_station, capsys):
    path, _ = one_station
    # -r sim reads the simulated driver (hw/): its tone 0.2 MHz up is the
    # strongest channel
    assert scanner.main(["-r", "sim", "--sample_rate", "512k", "-n", "16",
                         "--seconds", "0.01", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[1].split()[:2] == ["6", "192.0k"]
    if not torch.cuda.is_available():
        # no silent move to the CPU
        with pytest.raises(SystemExit):
            scanner.main(["-r", path, "--sample_rate", "512k"])


def test_torch_parse_frequency_matches_jax():
    from rustradio_tpu.dtypes import parse_frequency as jparse
    from rustradio_tpu_torch.dtypes import parse_frequency

    for s in ["100k", "2M", "2.4g", "1_024_000", "48000", "3.5K"]:
        assert parse_frequency(s) == jparse(s)
    for bad in ["", "k", "12x"]:
        with pytest.raises(ValueError):
            parse_frequency(bad)
    assert importlib.import_module("rustradio_tpu_torch.io").read_samples \
        is rawfile.read_samples
