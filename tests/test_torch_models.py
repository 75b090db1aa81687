"""The port's FM models (rustradio_tpu_torch.models.fm) against
rustradio_tpu.models.fm on the same numpy inputs (JAX on the CPU)."""

import numpy as np
import pytest
import torch

from rustradio_tpu.models import fm as jfm
from rustradio_tpu_torch import convert
from rustradio_tpu_torch.models import fm


def _wire(rng, n):
    return (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0


def test_torch_fm_demod_chain_matches_jax():
    rng = np.random.RandomState(50)
    n = 1 << 14
    iq = (_wire(rng, n) + 1j * _wire(rng, n)).astype(np.complex64)
    got = fm.fm_demod_chain(torch.from_numpy(iq), gain=0.8).numpy()
    want = np.asarray(jfm.fm_demod_chain(iq, gain=0.8))
    assert got.shape == want.shape == (n // 4 - 1,)
    # the JAX CPU path filters by overlap-save FFT, the port by the direct
    # f32 sum; both feed the exact atan2, whose amplification at
    # near-zero filtered samples sets the budget (test_pallas.py: 1e-3 rad
    # for the chain; here well inside it)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("precision", ["w3", "i8"])
def test_torch_fm_planar_flat_and_packed_match_jax(precision):
    rng = np.random.RandomState(51)
    n = 3 * (1 << 13) + 77
    i, q = _wire(rng, n), _wire(rng, n)
    dc = -0.4 / 128  # the rtl-sdr (x - 127.4)/128 convention
    ti, tq = torch.from_numpy(i), torch.from_numpy(q)
    want = np.asarray(jfm.fm_demod_chain_planar(
        i, q, gain=0.8, precision=precision, dc_offset=dc))

    flat = fm.fm_demod_chain_planar(ti, tq, gain=0.8, precision=precision,
                                    dc_offset=dc).numpy()
    pi_, pq, n_packed = fm.fm_pack_planes(ti, tq, precision=precision)
    assert n_packed == n
    packed = fm.fm_demod_chain_planar(pi_, pq, gain=0.8, precision=precision,
                                      dc_offset=dc, n=n).numpy()
    assert flat.shape == packed.shape == want.shape == (-(-n // 4) - 1,)
    # kernel numerics (fast atan2, ~1e-4 rad) against JAX's composed CPU
    # fallback (FFT filter + exact atan2): the chain's w3/i8 budget
    np.testing.assert_allclose(flat, want, atol=3e-4, rtol=0)
    np.testing.assert_allclose(packed, flat, atol=1e-6, rtol=0)

    # the packed planes are JAX's own, element for element
    ji, jq, jn = jfm.fm_pack_planes(i, q, precision=precision)
    assert jn == n
    assert torch.equal(convert.packed_from_jax(np.asarray(ji), precision), pi_)
    assert torch.equal(convert.packed_from_jax(np.asarray(jq), precision), pq)


def test_torch_fm_models_numpy_input_needs_a_device():
    # a tensor stays on its device; numpy goes where the caller says, and
    # nowhere without being told
    rng = np.random.RandomState(52)
    n = 1 << 12
    i, q = _wire(rng, n), _wire(rng, n)
    iq = (i + 1j * q).astype(np.complex64)
    for call in (lambda **kw: fm.fm_demod_chain(iq, **kw),
                 lambda **kw: fm.fm_pack_planes(i, q, **kw),
                 lambda **kw: fm.fm_demod_chain_planar(i, q, precision="w3",
                                                       **kw)):
        with pytest.raises(ValueError, match="needs device="):
            call()
    ti, tq = torch.from_numpy(i), torch.from_numpy(q)
    assert torch.equal(fm.fm_demod_chain(iq, device="cpu"),
                       fm.fm_demod_chain(torch.from_numpy(iq)))
    assert torch.equal(
        fm.fm_demod_chain_planar(i, q, precision="w3", device="cpu"),
        fm.fm_demod_chain_planar(ti, tq, precision="w3"))
    pi_, pq, n_packed = fm.fm_pack_planes(i, q, device="cpu")
    ri, rq, _ = fm.fm_pack_planes(ti, tq)
    assert n_packed == n and torch.equal(pi_, ri) and torch.equal(pq, rq)
    assert pi_.device.type == "cpu"
