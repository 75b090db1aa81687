"""The port's AX.25 1200 bd receiver (rustradio_tpu_torch.models.ax25)
against rustradio_tpu.models.ax25 on the same numpy inputs (JAX on the
CPU): the front-end stage by stage, then the decoded payloads.

The corpus is ten frames of the decode-rate corpus of
tests/test_decode_rate.py (same amplitudes, clock drifts and noise), at
24 kHz.
"""

import numpy as np
import pytest
import torch

import rustradio_tpu.ops as jops
from rustradio_tpu import taps as jtaps
from rustradio_tpu.models import ax25 as jax25
from rustradio_tpu_torch import ops, taps
from rustradio_tpu_torch.models import ax25
from test_decode_rate import FS, _afsk, _nrzi_line
from test_models import make_afsk

FIR_BUDGET = 2e-5  # test_pallas_interpret.py:45, times max|y|


def _corpus(n_frames=10):
    noises = [0.0, 0.15, 0.3, 0.35, 0.4]
    rng = np.random.RandomState(0)
    parts, payloads = [], []
    for i in range(n_frames):
        p = f"N0CALL-{i%16}>APRS:T#{i:04d} corpus {'y'*(i%29)}".encode()
        payloads.append(p)
        amp = 0.05 + 0.95 * (i % 10) / 9
        drift = ((i % 7) - 3) / 3 * 0.015
        framed = ops.hdlc_frame(ops.fcs_add(np.frombuffer(p, np.uint8)))
        x = _afsk(_nrzi_line(framed), 1200.0 * (1 + drift), amp)
        parts.append(x + rng.randn(len(x)).astype(np.float32)
                     * (noises[i % 5] * amp))
    return np.concatenate(parts), payloads


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _erode(mask, k):
    """True where the k samples ending here are all in ``mask``."""
    c = np.concatenate([[0], np.cumsum(~mask)])
    out = np.zeros_like(mask)
    out[k - 1 :] = (c[k:] - c[: len(mask) - k + 1]) == 0
    return out


def test_torch_bell202_demod_matches_jax_stage_by_stage(corpus):
    audio, _ = corpus
    bp = taps.band_pass(FS, 400.0, 2700.0, 65)
    lp = taps.low_pass(FS, 1100.0, 200.0)
    # band-pass and Hilbert: the FIR budget
    band = ops.filter_float(torch.from_numpy(audio), bp)
    jband = np.asarray(jops.filter_float(audio, jtaps.band_pass(FS, 400.0, 2700.0, 65)))
    np.testing.assert_allclose(band.numpy(), jband,
                               atol=FIR_BUDGET * np.abs(jband).max(), rtol=0)
    analytic = ops.hilbert_transform(band, 65)
    janalytic = np.asarray(jops.hilbert_transform(jband, 65))
    np.testing.assert_allclose(analytic.numpy(), janalytic,
                               atol=FIR_BUDGET * np.abs(janalytic).max(), rtol=0)
    # the discriminator where the analytic signal is not silence: in the
    # silent leads the JAX CPU route's FFT filter leaves rounding noise
    # where the direct FIR leaves exact zeros, and either angle is arbitrary
    fm = ops.quadrature_demod(analytic, 1.0).numpy()
    jfm = np.asarray(jops.quadrature_demod(janalytic, 1.0))
    mag = np.abs(janalytic)
    live = np.minimum(mag[:-1], mag[1:]) > 1e-3 * mag.max()
    assert live.mean() > 0.9
    np.testing.assert_allclose(fm[live], jfm[live], atol=1e-4, rtol=0)
    # the low-passed NRZ, only where the whole low-pass window is live
    nrz = ax25.bell202_demod(torch.from_numpy(audio), FS).numpy()
    jnrz = np.asarray(jax25.bell202_demod(audio, FS))
    assert nrz.shape == jnrz.shape == (len(audio) - 1,)
    inner = _erode(live, len(lp))
    assert inner.mean() > 0.85
    np.testing.assert_allclose(nrz[inner], jnrz[inner], atol=1e-4, rtol=0)
    # the model is the same chain as the ops above
    want = ops.filter_float(torch.from_numpy(fm), lp).numpy() - np.float32(
        2 * np.pi * 1700 / FS)
    np.testing.assert_allclose(nrz, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("demod", ["discriminator", "tones"])
def test_torch_ax25_1200_rx_decodes_what_jax_decodes(corpus, demod):
    audio, payloads = corpus
    got = [bytes(p) for p in ax25.ax25_1200_rx(audio, FS, demod=demod,
                                               device="cpu")]
    want = [bytes(p) for p in jax25.ax25_1200_rx(audio, FS, demod=demod)]
    assert got == want
    assert len(set(got) & set(payloads)) >= 9
    # a tensor input stays on its device and decodes the same
    again = ax25.ax25_1200_rx(torch.from_numpy(audio), FS, demod=demod)
    assert [bytes(p) for p in again] == got


def test_torch_ax25_1200_rx_options_match_jax(corpus):
    # the reference-faithful chain, keep_checksum and fix_bits
    audio, _ = corpus
    audio = audio[: len(audio) // 2]
    for kw in (dict(band=None, symbol_taps=(0.5, 0.5)),
               dict(keep_checksum=True, fix_bits=True)):
        got = ax25.ax25_1200_rx(audio, FS, device="cpu", **kw)
        want = jax25.ax25_1200_rx(audio, FS, **kw)
        # the same frames; a bit position may differ by a symbol, since the
        # silent leads (exact zeros here, FFT rounding noise in JAX) can
        # give the clock recovery one symbol more or less before a frame
        assert [bytes(p) for p in got] == [bytes(p) for p in want]
        assert all(abs(a.bit_pos - b.bit_pos) <= 1 for a, b in zip(got, want))


def test_torch_ax25_1200_rx_iq_decodes_jax_iq():
    # the IQ of tests/test_models.py::test_ax25_1200_iq_input, made by JAX
    payload = b"VIA IQ FM CARRIER"
    audio = make_afsk(payload, fs=50_000.0)
    iq, _ = jops.vco(audio * 0.3, k=2 * np.pi * 3500.0 / 50_000.0)
    iq = np.conj(np.asarray(iq))
    pkts = ax25.ax25_1200_rx_iq(iq, 50_000.0, device="cpu")
    assert [bytes(p) for p in pkts] == [payload]
    assert [bytes(p) for p in jax25.ax25_1200_rx_iq(iq, 50_000.0)] == [payload]
    fm = ax25.iq_front_end(iq, 50_000.0, device="cpu").numpy()
    jfm = np.asarray(jax25.iq_front_end(iq, 50_000.0))
    assert fm.shape == jfm.shape
    # the exact atan2 of the same filtered stream, compared where that
    # stream is not the filter's start-up ripple (|y| from 1e-5 to 1e-3 in
    # the first half filter length, where the JAX FFT route's ~2e-7
    # rounding moves the angle by up to 1e-4 and more), and modulo 2 pi:
    # the ripple's sign flips put some angles on the +-pi cut
    y = np.abs(ops.filter_complex(torch.from_numpy(iq),
                                  taps.low_pass_complex(50e3, 20e3, 100.0)).numpy())
    live = np.minimum(y[:-1], y[1:]) > 1e-2 * y.max()
    assert live.mean() > 0.95
    d = (fm - jfm + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d[live]).max() <= 1e-4


def test_torch_ax25_1200_rx_rejects_unknown_modes():
    audio = np.zeros(4800, np.float32)
    # sync="events" is a mode now: silence decodes to nothing
    assert ax25.ax25_1200_rx(audio, FS, sync="events", device="cpu") == []
    with pytest.raises(ValueError, match="unknown sync 'bogus'"):
        ax25.ax25_1200_rx(audio, FS, sync="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown demod"):
        ax25.ax25_1200_rx(audio, FS, demod="pll", device="cpu")
    with pytest.raises(ValueError, match="unknown sync"):
        ax25.ax25_1200_rx_iq(audio.astype(np.complex64), 50e3, sync="scan",
                             device="cpu")
    with pytest.raises(ValueError, match="device="):
        ax25.ax25_1200_rx(audio, FS)


def test_torch_ax25_1200_rx_events_sync_decodes_as_native(corpus):
    # the device clock recovery (kernel D's plain version here) decodes the
    # same frames as the native recurrence; bit positions may move by the
    # event form's closed-form rounding
    audio, payloads = corpus
    native = ax25.ax25_1200_rx(audio, FS, device="cpu")
    events = ax25.ax25_1200_rx(torch.from_numpy(audio), FS, sync="events")
    assert [bytes(p) for p in events] == [bytes(p) for p in native]
    assert set(bytes(p) for p in events) == set(payloads)


def test_torch_parse_ax25_matches_jax(corpus):
    audio, _ = corpus
    pkts = ax25.ax25_1200_rx(audio[: len(audio) // 3], FS, device="cpu")
    assert pkts
    for p in pkts:
        assert (p.addresses, p.info) == jax25.parse_ax25(p.data)


@pytest.mark.parametrize("fn", [ax25.bell202_demod, ax25.bell202_tone_demod])
def test_torch_bell202_demods_numpy_input_needs_a_device(corpus, fn):
    audio = corpus[0][:20_000]
    with pytest.raises(ValueError, match="needs device="):
        fn(audio, FS)
    got = fn(audio, FS, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, fn(torch.from_numpy(audio), FS))
