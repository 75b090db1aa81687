"""The port's whole-packet clock recovery and burst ops against the JAX
package: ``midpoint``, ``wpcr`` and ``wpcr_batch`` on the bursts of
tests/test_wpcr_batch.py held against the numpy golden model
``wpcr_numpy`` (the same best bin, the same symbols), a burst longer than
the JAX package's chirp bound, the WPCR decode-rate corpus, ``burst_tagger``
and ``stream_to_pdu``, and the two burst receivers on the synthetic inputs
of the JAX package's tests.  The JAX side runs on the CPU, the port on the
kernels' plain versions; inputs are seeded numpy arrays.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustradio_tpu.ops  # noqa: F401  (registers the submodule)
from rustradio_tpu import ops as jops
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.models import ax25
from rustradio_tpu_torch.ops.wpcr import wpcr_numpy
from test_models import make_afsk

JW = sys.modules["rustradio_tpu.ops.wpcr"]


def _make_burst(rng, nbits, sps, noise=0.05):
    bits = rng.randint(0, 2, nbits) * 2.0 - 1.0
    x = np.repeat(bits, sps).astype(np.float32)
    return x + rng.randn(len(x)).astype(np.float32) * noise


def _bursts():
    # tests/test_wpcr_batch.py:40-47: 15 bursts and 2 degenerate ones
    rng = np.random.RandomState(1)
    return [
        _make_burst(rng, rng.randint(20, 200), int(rng.choice([4, 5, 8, 10])))
        for _ in range(15)
    ] + [np.zeros(2, np.float32), np.ones(50, np.float32)]


def _numpy_emissions(samples: np.ndarray, sps: np.float32, phase: float):
    """The sample indices that ``wpcr_numpy``'s sequential f32 phase
    accumulator emits (its loop, returning positions)."""
    clock_phase = np.float32(phase)
    out = []
    for k in range(len(samples)):
        if clock_phase >= 1.0:
            clock_phase -= np.float32(1.0)
            out.append(k)
        clock_phase += sps
    return np.asarray(out, np.int64)


def _held_against_numpy(b: np.ndarray, syms: torch.Tensor, info: dict):
    """The port's result for burst ``b`` against ``wpcr_numpy`` over the
    port's midpointed burst: found and the bin (sps = bin / len) equal; the
    symbols equal, except where the reference's sequential f32 phase and
    the closed form that the port keeps (as the JAX package) round to
    different sides of an integer: there the phase u_k = phase + k*sps
    (float64) lies within 1e-4 of one, and a symbol moves by one sample.
    Returns whether the burst was found."""
    centred, ok = ops.midpoint(torch.from_numpy(b))
    want = wpcr_numpy(centred.numpy()) if len(b) >= 4 and bool(ok) else None
    assert info["found"] == (want is not None)
    assert not info["near_tie"]
    if want is None:
        return False
    assert info["sps"] == pytest.approx(want[1], abs=0)
    assert info["bin"] == round(want[1] * len(b))
    _, mask, _ = ops.wpcr(centred)
    assert torch.equal(centred[mask], syms)
    got_k = torch.nonzero(mask)[:, 0].numpy()
    want_k = _numpy_emissions(centred.numpy(), np.float32(info["sps"]),
                              info["phase"])
    assert len(got_k) == len(want_k) == len(want[0])
    u = np.float64(info["phase"]) + np.arange(len(b)) * np.float64(info["sps"])
    near = np.abs(u - np.round(u)) < 1e-4
    for k in np.flatnonzero(got_k != want_k):
        assert abs(int(got_k[k]) - int(want_k[k])) == 1
        assert near[min(got_k[k], want_k[k]):max(got_k[k], want_k[k]) + 1].any()
    np.testing.assert_array_equal(syms.numpy()[got_k == want_k],
                                  want[0][got_k == want_k])
    return True


def _midpoint_numpy(v: np.ndarray):
    """The reference Midpointer (src/wpcr.rs:53-82) in numpy: partition by
    the mean; high = sorted(above)[len/2], low = sorted(below)[len/2]."""
    mean = np.float32(np.sum(v, dtype=np.float64) / len(v))
    above = np.sort(v[v > mean])
    below = np.sort(v[~(v > mean)])
    if not len(above) or not len(below):
        return None
    high, low = above[len(above) // 2], below[len(below) // 2]
    return v - (low + (high - low) / np.float32(2.0))


def test_torch_midpoint_and_batch_match_numpy():
    bursts = [b for b in _bursts() if len(b)]
    batch = ops.midpoint_batch(bursts, device="cpu")
    for b, (centred, bok) in zip(bursts, batch):
        got, ok = ops.midpoint(torch.from_numpy(b))
        want = _midpoint_numpy(b)
        assert bool(ok) == bok == (want is not None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), want)
            assert torch.equal(centred, got)


def test_torch_midpoint_matches_jax():
    # two bursts (each length compiles the JAX form anew)
    for b in _bursts()[:2]:
        got, ok = ops.midpoint(torch.from_numpy(b))
        want, jok = JW.midpoint(jnp.asarray(b))
        assert bool(ok) == bool(jok)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_wpcr_batch_picks_numpys_bin_and_symbols():
    bursts = _bursts()
    batch = ops.wpcr_batch(bursts, device="cpu")
    assert len(batch) == len(bursts)
    found = sum(_held_against_numpy(b, s, i) for b, (s, i) in zip(bursts, batch))
    assert found >= 12, "the corpus must exercise the found path"


def test_torch_wpcr_one_burst_equals_batch():
    for b, (syms, info) in zip(_bursts(), ops.wpcr_batch(_bursts(), device="cpu")):
        centred, ok = ops.midpoint(torch.from_numpy(b))
        samples, mask, ii = ops.wpcr(centred)
        assert bool(ii["found"]) == (info["found"] and (len(b) < 4 or bool(ok)))
        if info["found"]:
            assert torch.equal(samples[mask], syms)
            assert float(ii["sps"]) == info["sps"]
            assert float(ii["phase"]) == pytest.approx(info["phase"], abs=0)


def test_torch_wpcr_batch_long_burst():
    # 35000 samples: past the JAX package's int32 chirp bound (its eager
    # path); the port's int64 chirp takes it in its bucket
    rng = np.random.RandomState(3)
    long_burst = _make_burst(rng, 3500, 10)
    assert len(long_burst) > 32769
    (syms, info), = ops.wpcr_batch([long_burst], device="cpu")
    assert _held_against_numpy(long_burst, syms, info)
    (jsyms, jinfo), = JW.wpcr_batch([long_burst])
    assert jinfo["found"] and jinfo["sps"] == info["sps"]
    np.testing.assert_array_equal(syms.numpy(), jsyms)


@pytest.mark.slow
def test_torch_wpcr_batch_matches_jax_batch():
    bursts = _bursts()
    for (s, i), (js, ji) in zip(ops.wpcr_batch(bursts, device="cpu"),
                                JW.wpcr_batch(bursts)):
        assert i["found"] == ji["found"]
        if i["found"]:
            assert i["sps"] == ji["sps"]
            np.testing.assert_allclose(s.numpy(), js, atol=1e-4)


def _nrzi_line(bits):
    return (1 + np.cumsum(1 - np.asarray(bits))) % 2


def wpcr_corpus():
    """tests/test_decode_rate.py:203-228: 200 NRZ bursts, clock drift of
    +-1%, noise up to 0.55."""
    rng = np.random.RandomState(5)
    bursts, payloads = [], []
    for i in range(200):
        p = f"W#{i:03d} wpcr corpus".encode()
        payloads.append(p)
        framed = ops.hdlc_frame(ops.fcs_add(np.frombuffer(p, np.uint8)))
        line = _nrzi_line(framed) * 2.0 - 1.0
        sps = 10.0 * (1 + ((i % 5) - 2) / 2 * 0.01)
        n = int(len(line) * sps)
        idx = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
        x = line[idx].astype(np.float32)
        x += rng.randn(n).astype(np.float32) * [0.0, 0.1, 0.25, 0.4, 0.55][i % 5]
        bursts.append(x)
    return bursts, payloads


def test_torch_wpcr_decode_rate_corpus():
    bursts, payloads = wpcr_corpus()
    decoded = 0
    results = ops.wpcr_batch(bursts, device="cpu")
    for b, p, (syms, info) in zip(bursts, payloads, results):
        # the numpy golden model's bin on every burst, and its symbols
        if not _held_against_numpy(b, syms, info):
            continue
        bits = ops.nrzi_decode(ops.binary_slicer(syms))
        pkts, _ = ops.hdlc_deframe(bits, 5, 1500)
        decoded += any(bytes(np.asarray(d)) == p for d, _ in pkts)
    assert decoded >= 100, f"WPCR decode rate: {decoded}/200"


@pytest.mark.parametrize("chunk", [None, 37])
def test_torch_burst_tagger_and_stream_to_pdu_match_jax(chunk):
    rng = np.random.RandomState(6)
    trigger = (rng.rand(600) > 0.6).astype(np.float32)
    trigger[100:160] = 1.0
    data = rng.randn(600).astype(np.float32)
    n = len(trigger) if chunk is None else chunk
    start, end = [], []
    last = jlast = False
    for a in range(0, len(trigger), n):
        s, e = ops.burst_tagger(torch.from_numpy(trigger[a:a + n]), 0.5, last)
        js, je = jops.burst_tagger(jnp.asarray(trigger[a:a + n]), 0.5, jlast)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        last = jlast = bool(trigger[a:a + n][-1] > 0.5)
        start.append(s)
        end.append(e)
    start, end = torch.cat(start), torch.cat(end)
    for tail, max_size in ((0, 10_000), (7, 10_000), (3, 20)):
        got = ops.stream_to_pdu(torch.from_numpy(data), start, end, max_size, tail)
        want = jops.stream_to_pdu(data, start.numpy(), end.numpy(), max_size, tail)
        assert len(got) == len(want) > 10
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_torch_ax25_1200_wpcr_rx_synthetic():
    # tests/test_models_extra.py:51-62
    fs = 50_000.0
    payload = b"WPCR 1200 BAUD BURST"
    audio = make_afsk(payload, fs=fs, lead_zeros=0)
    iq, _ = ops.vco(torch.from_numpy(audio * 0.3), k=2 * np.pi * 3500.0 / fs)
    iq = np.conj(iq.numpy())
    lead = np.zeros(4000, np.complex64)
    iq = np.concatenate([lead, iq, lead])
    rng = np.random.RandomState(7)
    iq = iq + (rng.randn(len(iq)) * 1e-4).astype(np.complex64)
    pkts = ax25.ax25_1200_wpcr_rx(iq, fs, threshold=0.01, device="cpu")
    assert [bytes(p) for p in pkts] == [payload]


def test_torch_ax25_9600_wpcr_rx_synthetic():
    # tests/test_models.py:125-147
    fs, baud = 50_000.0, 9600.0
    payload = b"G3RUH 9600 BAUD TEST FRAME"
    framed = ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8)))
    framed = np.concatenate([framed, np.zeros(17, np.uint8)])
    line = ops.nrzi_encode(torch.from_numpy(framed))
    scrambled = ops.scramble(line)[0].numpy()
    sps = fs / baud
    nsamp = int(len(scrambled) * sps)
    bit_at = np.minimum((np.arange(nsamp) / sps).astype(int), len(scrambled) - 1)
    nrz = scrambled[bit_at].astype(np.float32) * 2 - 1
    iq, _ = ops.vco(torch.from_numpy(nrz * 0.5), k=2 * np.pi * 6000.0 / fs)
    iq = np.conj(iq.numpy())
    lead = np.zeros(3000, np.complex64)
    iq = np.concatenate([lead, iq, lead]) + (
        np.random.RandomState(0).randn(nsamp + 6000) * 0.001).astype(np.complex64)
    pkts = ax25.ax25_9600_wpcr_rx(iq, fs, new_rate=fs, threshold=0.01, tail=50,
                                  device="cpu")
    assert [bytes(p) for p in pkts] == [payload]


def test_torch_ax25_9600_wpcr_rx_g3ruh_bursts():
    # tests/test_wpcr_batch.py:84-99: four G3RUH bursts from the port's
    # own transmitter, at 50 kHz
    payloads = [f"M0THC-1>APRS-{i}:batched wpcr {i}".encode() for i in range(4)]
    parts = [torch.zeros(20_000, dtype=torch.complex64)]
    for p in payloads:
        parts.append(ax25.g3ruh_modulate([np.frombuffer(p, np.uint8)], 50_000.0,
                                         device="cpu"))
        parts.append(torch.zeros(20_000, dtype=torch.complex64))
    pkts = ax25.ax25_9600_wpcr_rx(torch.cat(parts), 50_000.0)
    assert {bytes(p) for p in pkts} == set(payloads)


def test_torch_wpcr_numpy_input_needs_a_device():
    with pytest.raises(ValueError, match="device="):
        ops.wpcr_batch([np.ones(10, np.float32)])
    with pytest.raises(ValueError, match="device="):
        ax25.ax25_1200_wpcr_rx(np.zeros(100, np.complex64), 50_000.0)
