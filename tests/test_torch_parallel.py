"""Parity of the port's multi-device layer (rustradio_tpu_torch.parallel)
with the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port on ``make_mesh(8, device="cpu")``, eight shards on one
device, so every halo is real.  Both get the same numpy inputs from one
seed, and each comparison keeps the JAX test's tolerance
(``tests/test_parallel.py``, ``tests/test_channelizer.py``).  Each port
op is also held against the port's own offline op: bit for bit where the
per-output arithmetic is the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import rustradio_tpu.ops as jops
import rustradio_tpu.parallel as jpar
from rustradio_tpu import taps as jtaps
from rustradio_tpu_torch import ops, parallel, taps
from rustradio_tpu_torch.parallel import make_mesh

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= N_DEV, "conftest should force 8 CPU devices"
    return jpar.make_mesh(N_DEV), make_mesh(N_DEV, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_or_ulp(got, want):
    """Equal but where the CPU's vectorised loops take their scalar tail
    (a shard's or a row's last elements): there within 2 ulps, at most a
    few samples a shard."""
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=2)
    assert int((got != want).sum()) <= 8 * N_DEV


def test_torch_mesh_shapes_and_shards():
    mesh = make_mesh(4, device="cpu")
    assert mesh.shape == {"time": 4} and mesh.local == 4 and mesh.first == 0
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(8, axis="chan", device="cpu").shape["chan"] == 8
    shards = parallel.time_axis_spec(mesh).shard(np.arange(12.0))
    assert [s.tolist() for s in shards] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                            [9, 10, 11]]
    with pytest.raises(ValueError, match="not divisible"):
        parallel.time_axis_spec(mesh).shard(np.arange(10.0))


def test_torch_make_mesh_never_falls_back_to_the_cpu():
    # no CUDA here: without device= a mesh raises rather than land on the CPU
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh()
    parallel.init_distributed()  # no coordinator: a no-op
    assert not torch.distributed.is_initialized()


def test_torch_halo_exchange_left_and_right():
    mesh = make_mesh(4, device="cpu")
    x = torch.arange(16, dtype=torch.float32)
    shards = list(x.split(4))
    left = parallel.halo_exchange_left(shards, 2, mesh)
    assert left[0].tolist() == [0, 0, 0, 1, 2, 3]  # zeros on shard 0
    for i in range(1, 4):
        assert torch.equal(left[i], x[4 * i - 2 : 4 * i + 4])
    right = parallel.halo_exchange_right(shards, 3, mesh, fill=-1)
    assert right[3].tolist() == [12, 13, 14, 15, -1, -1, -1]  # fill on the last
    for i in range(3):
        assert torch.equal(right[i], x[4 * i : 4 * i + 7])
    # a carried tail in place of the zeros, complex streams, no halo
    c = torch.complex(x, -x)
    first = torch.tensor([7 + 1j, 8 + 2j], dtype=torch.complex64)
    ext = parallel.halo_exchange_left(list(c.split(4)), 2, mesh, first=first)
    assert torch.equal(ext[0][:2], first) and ext[0].dtype == torch.complex64
    assert parallel.halo_exchange_left(shards, 0, mesh) == shards
    with pytest.raises(ValueError, match="longer than a shard"):
        parallel.halo_exchange_left(shards, 5, mesh)


def test_torch_sharded_fir_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(0)
    x = (rng.randn(8 * 512) + 1j * rng.randn(8 * 512)).astype(np.complex64)
    t = rng.randn(33).astype(np.float32).astype(np.complex64)
    got = parallel.sharded_fir_filter(_t(x), t, mesh)
    want = np.asarray(jpar.sharded_fir_filter(jnp.asarray(x), t, jmesh))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the same sum per output as the port's offline full convolution
    assert torch.equal(got, ops.fir_filter_full(_t(x), t))


def test_torch_sharded_fir_decimating_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(1)
    x = rng.randn(8 * 512).astype(np.float32)
    t = rng.randn(17).astype(np.float32)
    got = parallel.sharded_fir_filter(_t(x), t, mesh, deci=4)
    want = np.asarray(jpar.sharded_fir_filter(jnp.asarray(x), t, jmesh, deci=4))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the offline op: the same taps over the same samples, but the plain
    # version's strided convolution sums a row's last outputs on another
    # path, so the shards' last outputs differ by an ulp; kernel A's budget
    off = ops.fir_filter_full(_t(x), t, 4)
    assert float((got - off).abs().max()) <= 2e-5 * float(off.abs().max())
    # the shards as a list give the same stream
    shards = parallel.time_axis_spec(mesh).shard(x)
    assert torch.equal(parallel.sharded_fir_filter(shards, t, mesh, deci=4), got)


def test_torch_sharded_fft_filter_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(2)
    x = (rng.randn(8 * 1024) + 1j * rng.randn(8 * 1024)).astype(np.complex64)
    t = (rng.randn(63) + 1j * rng.randn(63)).astype(np.complex64)
    got = parallel.sharded_fft_filter(_t(x), t, mesh)
    want = np.asarray(jpar.sharded_fft_filter(jnp.asarray(x), t, jmesh))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3)
    # other FFT frames than the offline op's: float32 FFT accuracy
    np.testing.assert_allclose(got.numpy(), ops.fft_filter(_t(x), t).numpy(),
                               atol=3e-3)


def test_torch_sharded_quadrature_demod_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(3)
    x = (rng.randn(8 * 256) + 1j * rng.randn(8 * 256)).astype(np.complex64)
    got = parallel.sharded_quadrature_demod(_t(x), 0.7, mesh)
    want = np.asarray(jpar.sharded_quadrature_demod(jnp.asarray(x), 0.7, jmesh))
    assert got.shape == (8 * 256,) and float(got[-1]) == 0.0
    np.testing.assert_allclose(got.numpy()[:-1], np.asarray(jops.quadrature_demod(x, 0.7)),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # each sample is the offline op's product and atan2; on the CPU torch's
    # vectorised atan2 takes a scalar path for a tensor's last elements, so
    # a shard's tail may differ in the last bit
    _same_or_ulp(got[:-1], ops.quadrature_demod(_t(x), 0.7))


def test_torch_sharded_fm_demod_chain_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.RandomState(4)
    n = 8 * 2048
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    t = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    assert np.array_equal(t, jtaps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0))
    got = parallel.sharded_fm_demod(_t(x), t, mesh, deci=4, gain=1.0)
    want_j = np.asarray(jpar.sharded_fm_demod(jnp.asarray(x), t, jmesh, deci=4))
    assert got.shape == want_j.shape
    np.testing.assert_allclose(got.numpy(), want_j, atol=1e-3)
    # the blocks' valid-conv streaming alignment: the offline chain
    want = ops.quadrature_demod(ops.fir_filter(_t(x), t, 4), 1.0)
    m = min(got.shape[0], want.shape[0])
    assert m >= want.shape[0] - 1
    _same_or_ulp(got[:m], want[:m])


def test_torch_sharded_fm_demod_output_length():
    # the JAX form's one-program shape check, on ones
    mesh = make_mesh(8, device="cpu")
    t = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    out = parallel.sharded_fm_demod(torch.ones(8 * 4096, dtype=torch.complex64),
                                    t, mesh, deci=4)
    assert out.shape == (8 * 4096 // 4 - (len(t) - 1) // 4 - 1,)


def test_torch_sharded_ops_reject_misaligned_lengths():
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        parallel.sharded_fir_filter(torch.ones(100, dtype=torch.complex64),
                                    np.ones(3), mesh, deci=4)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.sharded_fft_filter(torch.ones(100, dtype=torch.complex64),
                                    np.ones(3), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.sharded_quadrature_demod(torch.ones(100, dtype=torch.complex64),
                                          1.0, mesh)
    t = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    with pytest.raises(ValueError, match="must divide mesh"):
        parallel.sharded_fm_demod(torch.ones(8 * 4 * 10 + 4, dtype=torch.complex64),
                                  t, mesh, deci=4)
    with pytest.raises(ValueError, match="shorter than the halo"):
        parallel.sharded_fm_demod(torch.ones(8 * 4, dtype=torch.complex64),
                                  t, mesh, deci=4)


@pytest.mark.parametrize("op", ["fir", "fft", "quad", "fm_chain", "bank"])
def test_torch_sharded_ops_reject_unequal_shards(op):
    # a shard's global offset is its index times the shards' one length:
    # unequal shards (whose total still divides the mesh) or a list of
    # another count than the mesh's would misplace the decimation grid
    mesh = make_mesh(8, device="cpu")
    t = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    calls = {
        "fir": lambda xs: parallel.sharded_fir_filter(xs, t, mesh, deci=4),
        "fft": lambda xs: parallel.sharded_fft_filter(xs, t, mesh),
        "quad": lambda xs: parallel.sharded_quadrature_demod(xs, 1.0, mesh),
        "fm_chain": lambda xs: parallel.sharded_fm_demod(xs, t, mesh, deci=4),
        "bank": lambda xs: parallel.sharded_symbol_sync_bank(
            [x.real.reshape(-1, 4) for x in xs], 4.0,
            make_mesh(8, axis="chan", device="cpu")),
    }
    lens = [60, 68] + [64] * 6  # 512 samples: 8 shards of 64 in all
    unequal = [torch.ones(m, dtype=torch.complex64) for m in lens]
    with pytest.raises(ValueError, match="8 shards of one length"):
        calls[op](unequal)
    with pytest.raises(ValueError, match="8 shards of one length"):
        calls[op]([torch.ones(64, dtype=torch.complex64)] * 4)
    calls[op]([torch.ones(64, dtype=torch.complex64)] * 8)


def _afsk_audio(n, fs, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    gate = np.sin(2 * np.pi * 30 * t) > 0
    return (0.5 * np.sin(2 * np.pi * 1200 * t) * gate
            + 0.5 * np.sin(2 * np.pi * 2200 * t) * ~gate
            + 0.01 * rng.randn(n)).astype(np.float32)


def _live_inner(audio, fs):
    """Where the JAX analytic signal of the band-passed audio is live (above
    1e-3 of its peak) over the whole 1100 Hz low-pass window."""
    band = jops.filter_float(audio, jtaps.band_pass(fs, 400.0, 2700.0, 65))
    mag = np.abs(np.asarray(jops.hilbert_transform(band, 65)))
    live = np.minimum(mag[:-1], mag[1:]) > 1e-3 * mag.max()
    k = len(jtaps.low_pass(fs, 1100.0, 200.0))
    c = np.concatenate([[0], np.cumsum(~live)])
    out = np.zeros_like(live)
    out[k - 1:] = (c[k:] - c[: len(live) - k + 1]) == 0
    return out


def test_torch_sharded_bell202_demod_matches_jax(meshes):
    from rustradio_tpu.models.ax25 import bell202_demod as jbell202
    from rustradio_tpu_torch.models.ax25 import bell202_demod

    jmesh, mesh = meshes
    fs = 24_000.0
    audio = _afsk_audio(8 * 4096, fs, 9)
    got = parallel.sharded_bell202_demod(_t(audio), fs, mesh).numpy()
    want_j = np.asarray(jbell202(jnp.asarray(audio), fs))
    got_j = np.asarray(jpar.sharded_bell202_demod(jnp.asarray(audio), fs, jmesh))
    m = len(want_j)  # the offline chain emits n-1
    assert got.shape == got_j.shape and m == len(audio) - 1
    # against JAX where the analytic signal is not silence, the whole
    # low-pass window long, as tests/test_torch_ax25.py holds the offline
    # chain: in the lead (the Hilbert's delay line, then noise of 0.01)
    # the JAX CPU route's FFT filter leaves rounding noise where the
    # direct FIR leaves exact zeros, and either angle is arbitrary
    inner = _live_inner(audio, fs)
    assert inner.mean() > 0.95
    np.testing.assert_allclose(got[:m][inner], want_j[inner], atol=2e-3)
    np.testing.assert_allclose(got[:m][inner], got_j[:m][inner], atol=2e-3)
    # the port's own offline chain, everywhere: the same FIR sums over
    # other windows
    want = bell202_demod(_t(audio), fs).numpy()
    np.testing.assert_allclose(got[:m], want, atol=2e-3)


def test_torch_sharded_bell202_decodes_packets():
    import sys

    sys.path.insert(0, "tests")
    from test_models import make_afsk

    from rustradio_tpu_torch.models.ax25 import ax25_1200_rx

    mesh = make_mesh(N_DEV, device="cpu")
    fs = 24_000.0
    payloads = [f"MESH FRAME {i}".encode() for i in range(3)]
    audio = np.concatenate([make_afsk(p, fs=fs, lead_zeros=500) for p in payloads])
    audio = np.concatenate([audio, np.zeros((-len(audio)) % (8 * 256), np.float32)])
    nrz = parallel.sharded_bell202_demod(_t(audio), fs, mesh)
    syms = ops.recover_symbols(nrz, fs / 1200.0, 0.5, (0.5, 0.5))
    bits = ops.nrzi_decode(ops.binary_slicer(torch.from_numpy(syms)))
    pkts, _ = ops.hdlc_deframe(bits, 10, 1500)
    got = [bytes(np.asarray(d)) for d, _ in pkts]
    assert got == payloads
    assert got == [bytes(p) for p in ax25_1200_rx(audio, fs, device="cpu")]


def _nrz_bank(seed, c=8, nbits=60, sps=10):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (c, nbits)) * 2.0 - 1.0
    xs = np.repeat(bits, sps, axis=1).astype(np.float32)
    return xs + rng.randn(*xs.shape).astype(np.float32) * 0.05


@pytest.mark.parametrize("method", ["scan", "events"])
def test_torch_sharded_symbol_sync_bank_equals_the_unsharded_bank(method):
    from rustradio_tpu_torch.models.multichannel import recover_symbols_batch

    xs, sps = _nrz_bank(3), 10.0
    cmesh = make_mesh(8, axis="chan", device="cpu")
    vals, mask, clk, valid = parallel.sharded_symbol_sync_bank(
        _t(xs), sps, cmesh, method=method, return_valid=True)
    assert bool(valid.all()) and vals.shape == mask.shape == clk.shape == xs.shape
    # bit-equal to the unsharded bank (the same op per channel; the port's
    # bank is held to the JAX package's in tests/test_torch_symbol_sync.py)
    one = recover_symbols_batch(_t(xs), sps, method=method)
    for a, b in zip((vals, mask, clk), one):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        parallel.sharded_symbol_sync_bank(_t(xs), sps, cmesh, method=method),
        (vals, mask, clk)))
    with pytest.raises(ValueError, match="divisible"):
        parallel.sharded_symbol_sync_bank(_t(xs[:5]), sps, cmesh, method=method)
    with pytest.raises(ValueError, match="unknown method"):
        parallel.sharded_symbol_sync_bank(_t(xs), sps, cmesh, method="x")


@pytest.mark.slow  # the JAX sharded banks compile for ~16 s on the CPU
def test_torch_sharded_symbol_sync_bank_matches_jax_sharded():
    # tests/test_parallel.py::test_sharded_symbol_sync_bank's inputs and
    # tolerances, on the JAX sharded bank itself (8 virtual devices)
    xs, sps = _nrz_bank(3), 10.0
    jmesh = JMesh(np.asarray(jax.devices()[:8]), ("chan",))
    cmesh = make_mesh(8, axis="chan", device="cpu")
    for method in ("scan", "events"):
        vj, mj, cj = jpar.sharded_symbol_sync_bank(xs, sps, jmesh, method=method)
        vals, mask, clk = parallel.sharded_symbol_sync_bank(_t(xs), sps, cmesh,
                                                            method=method)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(mj))
        np.testing.assert_allclose(vals.numpy(), np.asarray(vj), atol=1e-6)
        np.testing.assert_allclose(clk.numpy(), np.asarray(cj), atol=1e-5)


def test_torch_sharded_channel_bank_matches_jax():
    from rustradio_tpu.parallel.channelizer import sharded_channelizer_fm as jbank

    m = 16
    rng = np.random.RandomState(1)
    x = (rng.randn(1 << 13) + 1j * rng.randn(1 << 13)).astype(np.complex64)
    h = parallel.channelizer_taps(m, taps_per_branch=4)
    got = parallel.sharded_channelizer_fm(_t(x), h, m, make_mesh(8, axis="chan",
                                                                device="cpu"))
    want = np.asarray(jbank(x, h, m, jpar.make_mesh(8, axis="chan")))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # channels are independent: the unsharded bank, at the JAX test's
    # tolerance (on the CPU the complex product of a 2-column block and of
    # the whole matrix round apart where the vectorised loop fuses)
    np.testing.assert_allclose(got.numpy(),
                               parallel.channelizer_fm_bank(_t(x), h, m).numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="12 channels over 8 shards"):
        parallel.sharded_channelizer_fm(_t(x), h, 12, make_mesh(8, axis="chan",
                                                                device="cpu"))


def test_torch_dryrun_multichip_on_cpu_shards(capsys):
    from rustradio_tpu_torch.tools.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu")
    assert res == {"ok": True, "devices": 4, "fm_outputs": 4083, "packets": 2}
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip(4)") == 8
