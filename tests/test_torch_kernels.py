"""Kernels B (the fused FM chain) and C (the standalone discriminator) of
the port against the JAX package.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX
side runs as its own tests run it: the CPU form of ``pallas_fm_chain``,
or the real kernel bodies under Pallas interpret mode where the packed or
windowed kernel is needed (as tests/test_pallas_interpret.py does).
Inputs are made with numpy from fixed RandomStates, on the 8-bit wire
grid the w2/w3/i8 modes require.  The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import rustradio_tpu.ops.pallas_kernels as pk
from rustradio_tpu_torch import convert, ops
from rustradio_tpu_torch.ops import kernels
from test_pallas_interpret import _fir_deci_f64, _fm_chain_f64

# the reference's own budgets against float64 (test_pallas_interpret.py:78-98)
BUDGET = {"highest": 2e-4, "w3": 3e-4, "w2": 8e-3, "split3": 8e-3, "i8": 3e-4}


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _wire(rng, n):
    return (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0


def _lp49():
    return np.asarray(np.hamming(49) * np.sinc(0.2 * (np.arange(49) - 24)),
                      np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("precision", list(BUDGET))
def test_torch_fm_chain_matches_jax_all_precisions(precision):
    rng = np.random.RandomState(3)
    n = 2 * 128 * 128 * 4 + 123
    a, b = _wire(rng, n), _wire(rng, n)
    taps = _lp49()
    got = kernels.fm_chain(_t(a), _t(b), taps, 4, 0.9,
                           precision=precision).numpy()
    want_jax = np.asarray(pk.pallas_fm_chain(a, b, taps, 4, 0.9,
                                             precision=precision))
    want = _fm_chain_f64(a, b, taps, 4, 0.9)
    assert got.shape == want_jax.shape == want.shape
    atol = BUDGET[precision]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=atol, rtol=0)


@pytest.mark.parametrize("precision", ["w3", "i8"])
def test_torch_fm_chain_offset_fold(precision):
    # DC offset folds in post-dot: filter(x + c) = filter(x) + c*sum(taps)
    rng = np.random.RandomState(4)
    n = 128 * 128 * 4
    a, b = _wire(rng, n), _wire(rng, n)
    taps = np.asarray(np.hamming(33), np.float32)
    c = 0.3125  # exact bf16 so the f64 model sees the same value
    got = kernels.fm_chain(_t(a), _t(b), taps, 4, 1.0, offset=c,
                           precision=precision).numpy()
    want_jax = np.asarray(pk.pallas_fm_chain(a, b, taps, 4, 1.0, offset=c,
                                             precision=precision))
    want = _fm_chain_f64(a.astype(np.float64) + c, b.astype(np.float64) + c,
                         taps, 4, 1.0)
    # the fold applies c under the zero history too (as the JAX kernels
    # do): skip the warm-up outputs for the f64 model only
    warm = -(-len(taps) // 4)
    np.testing.assert_allclose(got[warm:], want[warm:], atol=3e-4, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=3e-4, rtol=0)


@pytest.mark.parametrize("deci,ntaps", [(1, 31), (1, 128), (4, 128)])
def test_torch_fm_chain_i8_deci_taps_matrix(deci, ntaps):
    rng = np.random.RandomState(6)
    n = 128 * 128 * deci + 57
    a, b = _wire(rng, n), _wire(rng, n)
    taps = np.asarray(
        np.hamming(ntaps) * np.sinc(0.18 * (np.arange(ntaps) - ntaps // 2)),
        np.float32,
    )
    got = kernels.fm_chain(_t(a), _t(b), taps, deci, 0.8,
                           precision="i8").numpy()
    want = _fm_chain_f64(a, b, taps, deci, 0.8)
    # the reference's i8 matrix budget (test_pallas_interpret.py:119-120)
    assert float(np.max(np.abs(got - want))) < 5e-4


def test_torch_tap_splits_and_geometry_match_jax():
    rng = np.random.RandomState(30)
    taps = rng.randn(49).astype(np.float32)
    for terms in (2, 3):
        ref = np.asarray(pk._w_split_bf16(taps, terms), np.float32)
        got = np.concatenate(kernels.w_split_bf16(taps, terms))
        np.testing.assert_array_equal(got, ref)
    mats, scales = kernels.w_split_s8(taps, 3)
    ref_mats, ref_scales = pk._w_split_s8(taps, 3)
    np.testing.assert_array_equal(np.concatenate(mats), ref_mats)
    assert scales == ref_scales
    for n, ntaps, deci, tr in [(10_000, 49, 4, None), (70_000, 1205, 1, 16),
                               (5000, 33, 3, 100)]:
        t = np.ones(ntaps, np.float32)
        wlen, _, _, _, tile_rows, g, m, step, total = pk._fm_pack_geometry(
            n, t, deci, tr)
        assert tuple(kernels.fm_pack_geometry(n, t, deci, tr)) == (
            wlen, tile_rows, g, m, step, total)


@pytest.mark.parametrize("precision", ["highest", "w3", "i8"])
def test_torch_fm_chain_packed_matches_jax_db_kernel(interpret_kernels,
                                                     precision):
    # JAX's packed planes (the double-buffered kernel in interpret mode)
    # carried across with convert.packed_from_jax; the port's own packing
    # is the same array
    rng = np.random.RandomState(4)
    tile_rows = 16
    n = 3 * 128 * tile_rows * 4 + 57
    a, b = _wire(rng, n), _wire(rng, n)
    taps = _lp49()
    ja = np.asarray(pk.fm_plane_pack(a, taps, 4, tile_rows, precision))
    jb = np.asarray(pk.fm_plane_pack(b, taps, 4, tile_rows, precision))
    pa = convert.packed_from_jax(ja, precision, device="cpu")
    pb = convert.packed_from_jax(jb, precision, device="cpu")
    assert torch.equal(pa, kernels.fm_plane_pack(_t(a), taps, 4, tile_rows,
                                                 precision))
    got = kernels.fm_chain(pa, pb, taps, 4, 0.9, tile_rows=tile_rows,
                           precision=precision, n=n).numpy()
    want_jax = np.asarray(pk.pallas_fm_chain(ja, jb, taps, 4, 0.9,
                                             tile_rows=tile_rows,
                                             precision=precision, n=n))
    want = _fm_chain_f64(a, b, taps, 4, 0.9)
    assert got.shape == want_jax.shape == want.shape
    atol = BUDGET[precision]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=atol, rtol=0)


@pytest.mark.parametrize("precision", ["w3", "i8"])
def test_torch_fm_chain_window_seed_and_last(interpret_kernels, precision):
    # two chained windows over a packed ring: seed in, last out; against
    # JAX's windowed kernel (interpret mode) fed the same seed, against
    # the f64 filtered stream, and against one two-window call
    rng = np.random.RandomState(12)
    tile_rows, deci = 16, 4
    n = 3 * deci * 128 * tile_rows
    a, b = _wire(rng, n), _wire(rng, n)
    taps = _lp49()
    ja = np.asarray(pk.fm_plane_pack(a, taps, deci, tile_rows, precision))
    jb = np.asarray(pk.fm_plane_pack(b, taps, deci, tile_rows, precision))
    pa = convert.packed_from_jax(ja, precision, device="cpu")
    pb = convert.packed_from_jax(jb, precision, device="cpu")

    def port(row0, g, seed):
        return kernels.fm_chain_window(pa, pb, taps, deci, 1.3, row0=row0,
                                       g=g, tile_rows=tile_rows,
                                       precision=precision, seed=seed)

    a1, last1 = port(0, 1, None)
    a2, last2 = port(tile_rows, 1, last1)
    both, last12 = port(0, 2, None)
    # same arithmetic for every sample: chaining changes nothing but the
    # order of f32 partial sums inside the plain convolution
    np.testing.assert_allclose(torch.cat([a1, a2]).numpy(), both.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(last2.numpy(), last12.numpy(), atol=1e-6,
                               rtol=0)

    # last = the window's final filtered sample, y[(row0+g*tile_rows)*128-1]
    y = (_fir_deci_f64(a, taps, deci) + 1j * _fir_deci_f64(b, taps, deci))
    k = 2 * tile_rows * 128 - 1
    np.testing.assert_allclose(last12.numpy(), [y[k].real, y[k].imag],
                               atol=2e-5 * np.abs(y).max(), rtol=0)

    j2 = np.asarray(pk.pallas_fm_chain_window(
        ja, jb, taps, deci, 1.3, row0=tile_rows, g=1, tile_rows=tile_rows,
        precision=precision, seed=last1.numpy()))
    np.testing.assert_allclose(a2.numpy(), j2, atol=BUDGET[precision], rtol=0)
    want = 1.3 * np.angle(np.conj(y[:-1]) * y[1:])
    np.testing.assert_allclose(both.numpy()[1:], want[: 2 * tile_rows * 128 - 1],
                               atol=BUDGET[precision], rtol=0)


@pytest.mark.parametrize("precision", ["highest", "w3", "i8"])
def test_torch_fm_chain_span_no_seed_is_the_zero_seed(precision):
    rng = np.random.RandomState(13)
    n = 4096
    a = kernels.plane_cast(_t(_wire(rng, n)), precision)
    b = kernels.plane_cast(_t(_wire(rng, n)), precision)
    kw = dict(first=2, count=900, shift=-48, precision=precision, offset=0.01)
    got, last = kernels.fm_chain_span(a, b, _lp49(), 4, 0.9, **kw)
    for zero in ((0.0, 0.0), torch.zeros(2)):
        want, want_last = kernels.fm_chain_span(a, b, _lp49(), 4, 0.9,
                                                seed=zero, **kw)
        assert torch.equal(got, want) and torch.equal(last, want_last)
    # an empty span hands the seed on as its last sample
    kw["count"] = 0
    assert torch.equal(kernels.fm_chain_span(a, b, _lp49(), 4, **kw)[1],
                       torch.zeros(2))
    assert torch.equal(
        kernels.fm_chain_span(a, b, _lp49(), 4, seed=(0.5, -1.0), **kw)[1],
        torch.tensor([0.5, -1.0]))


def test_torch_fm_chain_window_bounds():
    taps = _lp49()
    p = kernels.fm_plane_pack(torch.zeros(4 * 128 * 16), taps, 4, 16, "w3")
    with pytest.raises(ValueError, match="outside the packed planes"):
        kernels.fm_chain_window(p, p, taps, 4, row0=16, g=1, tile_rows=16)


def _wrapped(d, gain):
    """Difference folded into [-pi*|g|, pi*|g|): a +-pi branch flip of the
    angle (opposite signs of a near-zero Im) counts as no error."""
    g = abs(gain)
    return (d + np.pi * g) % (2 * np.pi * g) - np.pi * g


def _quad_f64(x, gain):
    d = np.conj(x[:-1].astype(np.complex128)) * x[1:].astype(np.complex128)
    return gain * np.arctan2(d.imag, d.real)


def test_torch_quad_demod_fast_matches_jax_interpret(interpret_kernels):
    # the interpret-mode TPU kernel at tile_rows=128 over 2 whole tiles and a
    # ragged one, so its seam repair is crossed (test_pallas_interpret.py:58)
    rng = np.random.RandomState(2)
    n, gain = 2 * 128 * 128 + 100, 0.7
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = ops.quad_demod_fast(_t(x), gain).numpy()
    want_jax = np.asarray(pk.pallas_quad_demod(x, gain, tile_rows=128))
    assert got.shape == want_jax.shape == (n - 1,)
    # same polynomial in f32: a few ulps, but XLA's rounding of Im may flip
    # the +-pi branch, hence the wrapped difference
    assert np.abs(_wrapped(got - want_jax, gain)).max() <= 1e-6 * gain
    # the polynomial's budget against float64 (test_pallas_interpret.py:67)
    assert np.abs(_wrapped(got - _quad_f64(x, gain), gain)).max() <= 2e-4 * gain


@pytest.mark.parametrize("n", [0, 1, 2, 129])
def test_torch_quad_demod_fast_edges(n):
    rng = np.random.RandomState(60 + n)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    before = dict(kernels.LAUNCHES)
    got = ops.quad_demod_fast(_t(x), -1.3).numpy()
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.shape == (max(n - 1, 0),) and got.dtype == np.float32
    if n >= 2:
        assert np.abs(_wrapped(got - _quad_f64(x, -1.3), -1.3)).max() <= 2e-4 * 1.3
        want_jax = np.asarray(pk.pallas_quad_demod(x, -1.3))
        assert np.abs(_wrapped(got - want_jax, -1.3)).max() <= 1e-6 * 1.3


def test_torch_quad_demod_fast_checks_inputs():
    with pytest.raises(ValueError, match="complex64"):
        kernels.quad_demod_fast(torch.zeros(8, dtype=torch.complex128))
    with pytest.raises(ValueError, match="complex64"):
        kernels.quad_demod_fast(torch.zeros(8))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.quad_demod_fast(torch.zeros(16, dtype=torch.complex64)[::2])


def test_torch_launch_recording_counts_apart_and_on_replay():
    # inside recording() a launch counts into the record (a CUDA graph
    # capture records it and runs nothing); replayed() adds it per replay
    ts = kernels.tapset(np.ones(3, np.float32))
    before = dict(kernels.LAUNCHES)
    with kernels.recording() as record:
        kernels._launched("fm_chain", ts)
        kernels._launched("fm_chain", ts)
        kernels._launched("quad_demod")
        with pytest.raises(RuntimeError, match="does not nest"):
            with kernels.recording():
                pass
    assert kernels.LAUNCHES == before
    assert record.counts == {"fm_chain": 2, "quad_demod": 1}
    assert len(record.tapsets) == 1 and record.tapsets[0] is ts
    try:
        kernels._launched("fm_chain", ts)  # outside: counted at once
        kernels.replayed(record)
        kernels.replayed(record)
        assert kernels.LAUNCHES["fm_chain"] == before["fm_chain"] + 5
        assert kernels.LAUNCHES["quad_demod"] == before["quad_demod"] + 2
    finally:
        kernels.LAUNCHES.update(before)
    # a CPU call launches nothing, recording or not
    with kernels.recording() as record:
        kernels.fir_decimate(torch.ones(8), np.ones(3, np.float32), 1)
    assert record.counts == {} and kernels.LAUNCHES == before
