"""The port's G3RUH modem against the JAX package: the LFSR scrambler and
descrambler (bit for bit, both JAX forms and the numpy golden model), the
VCO against a float64 model, the stream position ops, the transmitter
``g3ruh_modulate``, and the 9600 bd receiver ``ax25_9600_rx`` on its own
loopback.  The JAX side runs on the CPU, the port on the kernels' plain
versions; inputs are seeded numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rustradio_tpu import ops as jops
from rustradio_tpu.models import ax25 as jax25
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.models import ax25
from rustradio_tpu_torch.ops.scramble import descramble_numpy

_NS = [0, 1, 16, 17, 18, 511, 512, 1023, 1024, 1025, 1536, 3 * 512 + 5]


@pytest.mark.parametrize("n", _NS)
def test_torch_scramble_descramble_bit_equal_with_carried_state(n):
    rng = np.random.RandomState(40 + n)
    x = rng.randint(0, 2, n).astype(np.uint8)
    state = rng.randint(0, 2, 17).astype(np.uint8)
    for st in (None, state):
        want = {blk: jops.scramble(jnp.asarray(x), block=blk,
                                   state=None if st is None else jnp.asarray(st))
                for blk in (None, 512)}
        for blk in (None, 512):
            out, fin = ops.scramble(torch.from_numpy(x), block=blk,
                                    state=None if st is None else torch.from_numpy(st))
            for w in want.values():
                np.testing.assert_array_equal(out.numpy(), np.asarray(w[0]))
                np.testing.assert_array_equal(fin.numpy(), np.asarray(w[1]))
    # two chunks with the register carried equal one call
    a, sa = ops.scramble(torch.from_numpy(x[: n // 2]))
    b, sb = ops.scramble(torch.from_numpy(x[n // 2:]), state=sa)
    whole, sw = ops.scramble(torch.from_numpy(x))
    assert torch.equal(torch.cat([a, b]), whole) and torch.equal(sb, sw)
    hist = rng.randint(0, 2, 17).astype(np.uint8)
    got = ops.descramble(torch.from_numpy(x), history=torch.from_numpy(hist))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.descramble(jnp.asarray(x),
                                                history=jnp.asarray(hist))))
    np.testing.assert_array_equal(ops.descramble(torch.from_numpy(x)).numpy(),
                                  descramble_numpy(x))


def test_torch_vco_against_float64():
    # both packages' VCO against a float64 model, the phase carried across
    # two chunks; the port's error may be at most twice the JAX package's
    # (measured 8.4e-7 against 4.9e-6 at 5000 steps of |k x| ~ 0.4 rad:
    # the port sums the phase in float64, the JAX package in f32)
    rng = np.random.RandomState(41)
    x = (rng.randn(5000) * 3000).astype(np.float32)
    k = 2 * np.pi / 48_000
    ph = np.mod(np.cumsum(x.astype(np.float64) * np.float64(np.float32(k))) + 0.3,
                2 * np.pi)
    ref = np.sin(ph) + 1j * np.cos(ph)
    a, pa = ops.vco(torch.from_numpy(x[:2000]), k, 0.3)
    b, pb = ops.vco(torch.from_numpy(x[2000:]), k, pa)
    got = torch.cat([a, b]).numpy()
    jo, jp = jops.vco(jnp.asarray(x[:2000]), k, 0.3)
    jo2, _ = jops.vco(jnp.asarray(x[2000:]), k, jp)
    jerr = np.abs(np.concatenate([np.asarray(jo), np.asarray(jo2)]) - ref).max()
    err = np.abs(got - ref).max()
    assert err <= 2 * jerr, (err, jerr)
    assert err < 1e-4
    assert float(pb) == pytest.approx(ph[-1], abs=1e-4)


def test_torch_delay_skip_head_match_jax():
    x = np.arange(10, dtype=np.float32)
    for n in (0, 3, 10, 12):
        np.testing.assert_array_equal(ops.delay(torch.from_numpy(x), n).numpy(),
                                      np.asarray(jops.delay(jnp.asarray(x), n)))
        np.testing.assert_array_equal(ops.skip(torch.from_numpy(x), n).numpy(),
                                      np.asarray(jops.skip(jnp.asarray(x), n)))
        np.testing.assert_array_equal(ops.head(torch.from_numpy(x), n).numpy(),
                                      np.asarray(jops.head(jnp.asarray(x), n)))


def test_torch_g3ruh_modulate_matches_jax():
    # one short frame at 50 kHz: the same bits (scrambler, NRZI, hold) and
    # the VCO's phase (a float64 sum here, an f32 sum in JAX), then the
    # channel filter: 2e-5 of an envelope of ~0.57
    frame = np.frombuffer(b"SHORT G3RUH", np.uint8)
    want = np.asarray(jax25.g3ruh_modulate([frame], 50_000.0))
    got = ax25.g3ruh_modulate([frame], 50_000.0, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _loopback(raw: bytes, fs: float = 300_000.0) -> torch.Tensor:
    lead = torch.zeros(5000, dtype=torch.complex64)
    iq = ax25.g3ruh_modulate([np.frombuffer(raw, np.uint8)], fs, device="cpu")
    return torch.cat([lead, iq, lead])


@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_ax25_9600_rx_loopback(sync):
    # TX (examples/g3ruh.rs:246-283) -> RX (examples/ax25-9600-rx.rs:136-207)
    payload = b"G3RUH MODEM LOOPBACK TEST FRAME 0123456789"
    pkts = ax25.ax25_9600_rx(_loopback(payload), 300_000.0, sync=sync)
    assert [bytes(p) for p in pkts] == [payload]


def test_torch_ax25_9600_rx_addressed_frame_one_clock_tap():
    # the g3ruh modem's own clock-taps default (examples/g3ruh.rs:77-83)
    raw = b"\x82\xa0\xa4\xa6@@`\x9c`\x86\x82\x98\x98a\x03\xf0VERIFY G3RUH"
    pkts = ax25.ax25_9600_rx(_loopback(raw), 300_000.0, symbol_taps=(1.0,))
    assert [bytes(p) for p in pkts] == [raw]
    assert pkts[0].addresses == ["APRS", "N0CALL"]


def test_torch_ax25_9600_rx_refuses_before_work():
    iq = np.zeros(1000, np.complex64)
    with pytest.raises(ValueError, match="device="):
        ax25.ax25_9600_rx(iq, 300_000.0)
    with pytest.raises(ValueError, match="unknown sync"):
        ax25.ax25_9600_rx(iq, 300_000.0, sync="scan", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ax25.g3ruh_modulate([b"x"], 300_000.0)


@pytest.mark.slow
@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_ax25_9600_rx_matches_jax_receiver(sync):
    # the same capture through both receivers: the same packets
    iq = _loopback(b"G3RUH BOTH PACKAGES")
    want = [bytes(p) for p in jax25.ax25_9600_rx(iq.numpy(), 300_000.0, sync=sync)]
    got = [bytes(p) for p in ax25.ax25_9600_rx(iq, 300_000.0, sync=sync)]
    assert got == want == [b"G3RUH BOTH PACKAGES"]
