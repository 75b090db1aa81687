"""Parity of the port's small public names with the JAX package's:
``taps.multiband``, ``ops.hdlc_bit_hunt``, the tag helpers and
``StreamValue`` of ``streams``, ``dtypes.parse_verbosity`` and
``DEFAULT_CHUNK_SIZE``, the package's top-level exports, and
``utils.RateMeter`` / ``roofline_report``."""

import dataclasses

import numpy as np
import pytest
import torch

import rustradio_tpu as jrr
from rustradio_tpu.ops import hdlc as jhdlc
from rustradio_tpu import dtypes as jdtypes
from rustradio_tpu import streams as jstreams
from rustradio_tpu import taps as jtaps
from rustradio_tpu import windows as jwindows
import rustradio_tpu_torch as rr
from rustradio_tpu_torch import dtypes, ops, streams, taps, windows


@pytest.mark.parametrize("bands,ntaps", [([(0.0, 0.2)], 64), ([(0.1, 0.3), (0.6, 0.8)], 101),
                                          ([(0.0, 1.0)], 8)])
def test_torch_multiband_matches_jax(bands, ntaps):
    w = windows.hamming(ntaps)
    assert np.array_equal(w, jwindows.hamming(ntaps))
    got = taps.multiband(bands, ntaps, w)
    want = jtaps.multiband(bands, ntaps, jwindows.hamming(ntaps))
    assert got.dtype == np.complex64 and np.array_equal(got, want)


def test_torch_multiband_low_band_passes_dc_and_rejects_invalid():
    # tests/test_taps.py's two checks
    t = taps.multiband([(0.0, 0.2)], 64, windows.hamming(64))
    h = np.fft.fft(t, 1024)
    assert abs(h[0]) > 10 * abs(h[300])
    with pytest.raises(ValueError):
        taps.multiband([(0.0, 1.0)], 0, np.zeros(0, np.float32))
    with pytest.raises(ValueError):
        taps.multiband([(0.0, 3.0)], 8, np.ones(8, np.float32))


def test_torch_hdlc_bit_hunt_matches_jax():
    rng = np.random.RandomState(30)
    flag = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
    bits = np.concatenate([flag, rng.randint(0, 2, 200).astype(np.uint8), flag, flag,
                           np.ones(9, np.uint8), rng.randint(0, 2, 50).astype(np.uint8)])
    got_flag, got_run = ops.hdlc_bit_hunt(torch.from_numpy(bits))
    want_flag, want_run = jhdlc.hdlc_bit_hunt(bits)
    assert got_flag.dtype == torch.bool and got_run.dtype == torch.int64
    assert np.array_equal(got_flag.numpy(), np.asarray(want_flag))
    assert np.array_equal(got_run.numpy(), np.asarray(want_run))
    assert got_flag.numpy().sum() >= 3 and int(got_run.max()) >= 9
    # all ones from the start: the run counts from the stream's first bit
    f, r = ops.hdlc_bit_hunt(torch.ones(5, dtype=torch.uint8))
    assert not f.any() and r.tolist() == [1, 2, 3, 4, 5]
    f, r = ops.hdlc_bit_hunt(torch.zeros(0, dtype=torch.uint8))
    assert f.shape == r.shape == (0,)


def _tags(tags):
    return [(t.pos, t.key, t.val) for t in tags]


def test_torch_tag_helpers_match_jax():
    spec = [(0, "a", 1), (5, "b", "x"), (9, "c", None), (17, "d", 2.5)]
    got = [streams.Tag(*s) for s in spec]
    want = [jstreams.Tag(*s) for s in spec]
    for args in ((1, 1), (3, 2), (1, 4)):
        assert _tags(streams.scale_tags(got, *args)) == _tags(jstreams.scale_tags(want, *args))
    assert _tags(streams.shift_tags(got, -3)) == _tags(jstreams.shift_tags(want, -3))
    assert _tags(streams.filter_tags(got, 5, 17)) == _tags(jstreams.filter_tags(want, 5, 17))
    assert streams.scale_tags(got) is not got  # a copy, as the JAX helper
    v = streams.StreamValue(torch.arange(3))
    assert v.tags == [] and torch.equal(v.data, torch.arange(3))
    assert [f.name for f in dataclasses.fields(streams.StreamValue)] == \
        [f.name for f in dataclasses.fields(jstreams.StreamValue)]


def test_torch_dtypes_match_jax():
    assert dtypes.DEFAULT_CHUNK_SIZE == jdtypes.DEFAULT_CHUNK_SIZE == 1 << 20
    for s in ("error", "WARN", "info", "Debug", "trace"):
        assert dtypes.parse_verbosity(s) == jdtypes.parse_verbosity(s)
    with pytest.raises(ValueError, match="valid values"):
        dtypes.parse_verbosity("loud")
    for s in ("100k", "2M", "2.4g", "1_000"):
        assert dtypes.parse_frequency(s) == jdtypes.parse_frequency(s)
    assert (dtypes.Float, dtypes.Complex) == (torch.float32, torch.complex64)
    # every JAX stream dtype by its numpy name (torch.uint8 -> "uint8")
    for name in ("Float", "Complex", "U8", "I16", "I32", "U32", "U64", "Bit"):
        want = np.dtype(getattr(jdtypes, name)).name
        assert str(getattr(dtypes, name)).removeprefix("torch.") == want, name
    assert dtypes.Bit is dtypes.U8
    assert dtypes.NP_FLOAT is jdtypes.NP_FLOAT is np.float32
    assert dtypes.NP_COMPLEX is jdtypes.NP_COMPLEX is np.complex64


def test_torch_top_level_exports_cover_jax():
    assert set(jrr.__all__) <= set(rr.__all__)
    assert rr.Complex is torch.complex64 and rr.Float is torch.float32
    assert rr.parse_verbosity is dtypes.parse_verbosity
    assert rr.parse_frequency("2M") == 2e6
    assert rr.StreamValue is streams.StreamValue and rr.Pdu is streams.Pdu
    token = rr.CancellationToken()
    assert not token.is_cancelled()
    token.cancel()
    assert token.is_cancelled()
    assert rr.dtypes is dtypes
    assert rr.__version__ == jrr.__version__ == "0.1.0"


def test_torch_utils_exports_rate_meter_and_roofline():
    from rustradio_tpu_torch.utils import RateMeter, roofline_report

    m = RateMeter()
    m.add(1000)
    m.add(500)
    assert m.samples == 1500 and "1500 samples" in m.report()
    assert "GB/s" in roofline_report(2e9, 1.0, "cpu")
