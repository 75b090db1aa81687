"""Parity of the port's ops (rustradio_tpu_torch.ops) with the JAX package.

Every input is made with numpy from a fixed RandomState and fed to both
packages; JAX runs on the CPU.  On CPU tensors the port's kernel wrappers
run their plain PyTorch versions, so these tests pin the arithmetic the
CUDA kernels are held to on the card.
"""

import numpy as np
import pytest
import torch

import rustradio_tpu.ops as jops
import rustradio_tpu.ops.pallas_kernels as pk
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.ops import kernels
from test_pallas_interpret import _fir_deci_f64


def test_torch_fast_atan2_matches_jax():
    rng = np.random.RandomState(20)
    y = rng.randn(4096).astype(np.float32)
    x = rng.randn(4096).astype(np.float32)
    # octant edges, signed zeros and the 0/0 corner
    y[:8] = [0.0, -0.0, 1.0, -1.0, 1.0, 0.0, 1e-30, -2.0]
    x[:8] = [0.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1e-30, 2.0]
    got = ops.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(pk.fast_atan2(y, x))
    # same polynomial and reduction in f32: only rounding order differs
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and the polynomial's own budget against the exact atan2
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=1e-4, rtol=0)


def test_torch_quadrature_demod_matches_jax():
    rng = np.random.RandomState(21)
    x = (rng.randn(5000) + 1j * rng.randn(5000)).astype(np.complex64)
    got = ops.quadrature_demod(torch.from_numpy(x), 0.7).numpy()
    want = np.asarray(jops.quadrature_demod(x, 0.7))
    assert got.shape == want.shape == (4999,)
    # f32 complex product + f32 atan2 in both: a few ulps of pi
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_torch_fast_fm_matches_jax():
    rng = np.random.RandomState(22)
    x = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    got = ops.fast_fm(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.fast_fm(x))
    # the same three f32 products and differences
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _fir_valid_f64(x, taps, deci):
    full = _fir_deci_f64(x, taps, 1)
    return full[len(taps) - 1 :: deci]


@pytest.mark.parametrize("ntaps,deci,n", [(49, 4, 6000), (130, 1, 5000),
                                          (1205, 1, 6000)])
@pytest.mark.parametrize("form", ["valid", "full"])
@pytest.mark.parametrize("cplx", [False, True])
def test_torch_fir_filter_matches_jax_and_f64(ntaps, deci, n, form, cplx):
    rng = np.random.RandomState(23 + ntaps)
    taps = rng.randn(ntaps).astype(np.float32)
    x = rng.randn(n).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.randn(n)).astype(np.complex64)
    port_fn = ops.fir_filter if form == "valid" else ops.fir_filter_full
    jax_fn = jops.fir_filter if form == "valid" else jops.fir_filter_full
    model = _fir_valid_f64 if form == "valid" else _fir_deci_f64
    got = port_fn(torch.from_numpy(x), taps, deci).numpy()
    want_jax = np.asarray(jax_fn(x, taps, deci))
    want = model(x.real, taps, deci) + (1j * model(x.imag, taps, deci)
                                        if cplx else 0)
    assert got.shape == want_jax.shape == want.shape
    # f32 sums of up to 1205 products: the reference's own FIR budget
    # (test_pallas_interpret.py: 2e-5 * max|y|)
    tol = 2e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, want_jax, atol=tol, rtol=0)


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("deci,n", [(1, 3001), (4, 4099)])
def test_torch_fir_decimate_complex_input_matches_jax(complex_taps, deci, n):
    # the plane-batched plain version (I and Q as the two rows of one
    # convolution; complex taps as two such calls) against
    # pallas_fir_decimate's host route, which filters plane by plane
    rng = np.random.RandomState(26 + deci)
    taps = rng.randn(49).astype(np.float32)
    if complex_taps:
        taps = (taps + 1j * rng.randn(49)).astype(np.complex64)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = kernels.fir_decimate(torch.from_numpy(x), taps, deci).numpy()
    want = np.asarray(pk.pallas_fir_decimate(x, taps, deci))
    assert got.shape == want.shape == (-(-n // deci),)
    assert got.dtype == np.complex64
    # f32 sums of 49 products in two orders: the FIR budget
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                               rtol=0)
    # and each plane alone, filtered as a real stream
    re = kernels.fir_decimate(torch.from_numpy(x.real.copy()), taps, deci)
    np.testing.assert_allclose(got, re.numpy() + 1j * kernels.fir_decimate(
        torch.from_numpy(x.imag.copy()), taps, deci).numpy(),
        atol=2e-5 * np.abs(want).max(), rtol=0)


def test_torch_fir_decimate_real_input_complex_taps():
    # a real stream through complex taps: real and imaginary tap sets
    rng = np.random.RandomState(28)
    taps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    x = rng.randn(2000).astype(np.float32)
    got = kernels.fir_decimate(torch.from_numpy(x), taps, 3).numpy()
    want = np.asarray(pk.pallas_fir_decimate(x, taps, 3))
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                               rtol=0)


def test_torch_tapset_is_found_by_content_and_passes_through():
    rng = np.random.RandomState(29)
    taps = rng.randn(49).astype(np.float32)
    ts = kernels.tapset(taps)
    assert kernels.tapset(ts) is ts and kernels.tapset(taps.copy()) is ts
    assert kernels.tapset(taps.astype(np.complex64)) is ts
    assert len(ts) == 49 and not ts.taps.flags.writeable
    np.testing.assert_array_equal(np.asarray(ts), taps)
    x = torch.from_numpy(rng.randn(500).astype(np.float32))
    assert torch.equal(kernels.fir_decimate(x, ts, 4),
                       kernels.fir_decimate(x, taps, 4))
    # the fold constants and packed geometry of the record are the
    # functions' own
    assert ts.geometry(10_000, 4, None) == kernels.fm_pack_geometry(
        10_000, taps, 4)
    scale, dc = ts.consts("i8", 0.25)
    tapsum = np.float32(np.sum(taps, dtype=np.float64))
    assert scale == 1 / 128 and dc == float(
        (np.float32(1 / 128) + np.float32(0.25)) * tapsum)
    assert ts.consts("w3", 0.25) == (1.0, float(np.float32(0.25) * tapsum))
    with pytest.raises(ValueError, match="real taps"):
        kernels.tapset(np.array([1j, 1], np.complex64))


def test_torch_fir_decimate_complex_taps_four_launch_form():
    # complex taps take the 4-real-pass split (pallas_fir_decimate l.256-259)
    rng = np.random.RandomState(24)
    taps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    x = (rng.randn(2000) + 1j * rng.randn(2000)).astype(np.complex64)
    got = kernels.fir_decimate(torch.from_numpy(x), taps, 3).numpy()
    full = np.convolve(x.astype(np.complex128), taps.astype(np.complex128))
    want = full[: len(x)][::3]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                               rtol=0)


def test_torch_kernel_wrappers_check_inputs():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="1..4096 taps"):
        kernels.fir_decimate(x, np.ones(4097, np.float32), 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fir_decimate(torch.zeros(128)[::2], np.ones(3, np.float32), 1)
    with pytest.raises(ValueError, match="float32"):
        kernels.fir_decimate(x.double(), np.ones(3, np.float32), 1)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.fm_chain_span(x.double(), x.double(), np.ones(3, np.float32),
                              1, first=0, count=4, shift=0, precision="w3")
    with pytest.raises(ValueError, match="real taps"):
        kernels.fm_chain(x, x, np.array([1j, 1], np.complex64), 1)
    with pytest.raises(ValueError, match="unknown precision"):
        kernels.fm_chain(x, x, np.ones(3, np.float32), 1, precision="tf32")


def test_torch_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    rng = np.random.RandomState(25)
    x = torch.from_numpy(rng.randn(1000).astype(np.float32))
    taps = rng.randn(49).astype(np.float32)
    assert torch.equal(kernels.fir_decimate(x, taps, 4),
                       kernels.fir_decimate_plain(x, taps, 4))
    kernels.fm_chain(x, x, taps, 4)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("op,cplx,ntaps", [
    ("fft_filter", True, 3), ("fft_filter_float", False, 3),
    ("filter_float", False, kernels.MAX_TAPS + 1),
    ("filter_complex", True, kernels.MAX_TAPS + 1)])
def test_torch_fft_route_empty_input_gives_empty_output(op, cplx, ntaps):
    # the overlap-save route of each op, on a stream of no samples: an empty
    # output of the op's dtype on the input's device.  The JAX package's
    # overlap-save raises TypeError there (a reshape of zero frames).
    dtype = torch.complex64 if cplx else torch.float32
    taps = np.random.RandomState(ntaps).randn(ntaps).astype(np.float32)
    got = getattr(ops, op)(torch.zeros(0, dtype=dtype), taps)
    assert got.shape == (0,) and got.dtype == dtype and got.device.type == "cpu"
    x = np.zeros(0, np.complex64 if cplx else np.float32)
    with pytest.raises(TypeError):
        getattr(jops, op)(x, taps)
    if op == "fft_filter":  # its decimating form too
        assert ops.fft_filter_decimate(torch.zeros(0, dtype=dtype), taps,
                                       2).shape == (0,)
    # and the first sample after it is the filter's first output
    one = getattr(ops, op)(torch.ones(1, dtype=dtype), taps)
    np.testing.assert_allclose(one.numpy(), np.asarray(taps[:1], one.numpy().dtype),
                               rtol=1e-5)
