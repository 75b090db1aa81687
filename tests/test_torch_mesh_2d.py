"""The port's 2-D meshes (``parallel.make_mesh_2d``) against the JAX
package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces, as ``jpar.make_mesh_2d(4, 2)`` and ``(2, 4)``; the port on
``make_mesh_2d(.., device="cpu")``, eight shards on one device.  Both get
the same numpy inputs from one seed.  Each function that takes a mesh is
held three ways (``held``):

* against the JAX package on the same 2-D mesh shape, at the tolerance
  the 1-D case of the same function uses in ``tests/test_torch_parallel.py``
  / ``test_torch_graph_mesh.py`` / ``test_torch_pipeline.py`` (stated in
  each test);
* against the port's own run on a 1-D mesh of ``mesh.shape[axis]``
  shards, bit for bit;
* every replica line (``Mesh.replicas``) against the others, bit
  for bit.

The JAX sharded clock-recovery banks compile for ~20 s on the CPU: their
comparison is ``tests/test_torch_mesh_2d_bank.py`` (``slow``); the mesh
across two gloo processes is ``tests/test_torch_mesh_2d_multihost.py``.
"""

import numpy as np
import pytest
import torch

# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process (~2 s); import it with the module instead, so
# that no test's time holds it
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

import rustradio_tpu.blocks as jblocks
import rustradio_tpu.graph as jgraph
import rustradio_tpu.parallel as jpar
from rustradio_tpu import taps as jtaps
from rustradio_tpu.parallel.channelizer import sharded_channelizer_fm as jbank_fm
from rustradio_tpu.parallel.graph_mesh import shard_chain as jshard_chain
from rustradio_tpu_torch import blocks, ops, parallel, taps
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
from rustradio_tpu_torch.parallel import make_mesh, make_mesh_2d
from rustradio_tpu_torch.parallel.graph_mesh import chain_segment, shard_chain
from rustradio_tpu_torch.parallel.mesh import Mesh, global_len
from rustradio_tpu_torch.streams import Tag
from test_torch_graph_mesh import BP, LP, LP48, bell, fir_chain, hold_demod

SHAPES = [(4, 2), (2, 4)]  # (n_time, n_chan)
FS = 24_000.0


@pytest.fixture(scope="module")
def jmeshes():
    assert jax.device_count() >= 8, "conftest should force 8 CPU devices"
    return {s: jpar.make_mesh_2d(*s) for s in SHAPES}


def _mesh(shape):
    return make_mesh_2d(*shape, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _crand(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _rand(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return a.shape == b.shape and torch.equal(a, b)


def held(fn, mesh, axis):
    """``fn(mesh)`` on the 2-D mesh: every replica line recorded equal to
    the others bit for bit (each line along ``axis`` one entry of every
    record), and the result equal bit for bit to ``fn`` on a 1-D mesh of
    ``mesh.shape[axis]`` shards.  Returns the 2-D result."""
    with mesh.replicas() as seen:
        got = fn(mesh)
    n_lines = mesh.local // mesh.shape[axis]
    assert seen and all(len(e) == n_lines for e in seen), [len(e) for e in seen]
    for e in seen:
        assert all(_same(t, e[0]) for t in e[1:])
    one = fn(make_mesh(mesh.shape[axis], axis=axis, device="cpu"))
    assert _same(got, one)
    return got


# ---- the mesh


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_make_mesh_2d_layout_matches_jax(jmeshes, shape):
    jm, pm = jmeshes[shape], _mesh(shape)
    assert pm.axis_names == tuple(jm.axis_names) == ("chan", "time")
    assert pm.shape == dict(jm.shape) and pm.grid == jm.devices.shape
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert pm.devices == (torch.device("cpu"),) * 8 and pm.local == 8
    for j in range(8):  # shard j stands for JAX's device j
        assert pm.coords(j) == tuple(int(c) for c in np.argwhere(ids == j)[0])
    # the lines along each axis: JAX's rows (time) and columns (chan)
    assert [ln.local for ln in pm.lines("time")] == [tuple(r) for r in ids]
    assert [ln.local for ln in pm.lines("chan")] == [tuple(c) for c in ids.T]
    for axis in ("time", "chan"):
        assert all(ln.ks == tuple(range(pm.shape[axis])) and ln.prev is None
                   and ln.next is None for ln in pm.lines(axis))
        assert pm.home(axis).index == 0 and not pm.crosses(axis)
    # the same grid built from its devices
    built = Mesh(["cpu"] * 8, ("chan", "time"), grid=(shape[1], shape[0]))
    assert built.shape == pm.shape and built.lines("chan") == pm.lines("chan")
    with pytest.raises(ValueError, match="is not 1 process"):
        Mesh(["cpu"] * 8, ("chan", "time"), grid=(3, 2))


def test_torch_make_mesh_2d_device_rules(monkeypatch):
    # nothing lands on the CPU unasked: no card, no device= -> raises
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh_2d(2, 2, device="cuda:0")
    # with cards: the first n_time * n_chan of them in grid order, and too
    # few raises (device objects only: no card is touched)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="asked for 8 devices, have 4"):
        make_mesh_2d(4, 2)
    m = make_mesh_2d(2, 2)
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert [ln.local for ln in m.lines("time")] == [(0, 1), (2, 3)]
    one = make_mesh_2d(2, 2, device="cuda:0")
    assert one.devices == (torch.device("cuda", 0),) * 4


def test_torch_mesh_2d_shards_and_halos():
    mesh = _mesh((4, 2))
    x = np.arange(16.0, dtype=np.float32)
    # a replica holds its line's shard
    time_sh = parallel.time_axis_spec(mesh, "time").shard(x)
    assert [s.tolist() for s in time_sh] == [list(x[4 * (j % 4):4 * (j % 4) + 4])
                                             for j in range(8)]
    chan_sh = parallel.time_axis_spec(mesh, "chan").shard(x)
    assert [s.tolist() for s in chan_sh] == [list(x[8 * (j // 4):8 * (j // 4) + 8])
                                             for j in range(8)]
    assert global_len(time_sh, mesh, "time") == 16
    assert global_len(chan_sh, mesh, "chan") == 16
    # each line exchanges its own halos: zeros on its shard 0, fill on its
    # last shard, the neighbours along the axis elsewhere
    left = parallel.halo_exchange_left(time_sh, 2, mesh, "time")
    right = parallel.halo_exchange_right(time_sh, 1, mesh, "time", fill=-1)
    for j in range(8):
        k = j % 4
        assert left[j].tolist() == ([0, 0] if k == 0 else list(x[4 * k - 2:4 * k])) \
            + list(x[4 * k:4 * k + 4])
        assert right[j].tolist() == list(x[4 * k:4 * k + 4]) + (
            [-1] if k == 3 else [x[4 * k + 4]])
    first = torch.tensor([7.0, 8.0])
    ext = parallel.halo_exchange_left(chan_sh, 2, mesh, "chan", first=first)
    for j in range(4):  # chan shard 0 of every time line
        assert ext[j][:2].tolist() == [7.0, 8.0]
        assert ext[j + 4][:2].tolist() == list(x[6:8])


def test_torch_mesh_2d_unknown_axis_raises():
    mesh = _mesh((4, 2))
    x = torch.ones(64, dtype=torch.complex64)
    bad = r"no axis 'stage'; its axes are \('chan', 'time'\)"
    with pytest.raises(ValueError, match=bad):
        parallel.sharded_fir_filter(x, np.ones(3), mesh, axis="stage")
    with pytest.raises(ValueError, match=bad):
        parallel.time_axis_spec(mesh, "stage").shard(x)
    with pytest.raises(ValueError, match=bad):
        parallel.pipeline_run([lambda v: v] * 2, torch.ones(2, 8), mesh)
    with pytest.raises(ValueError, match=bad):
        shard_chain([blocks.FirFilter(np.ones(3, np.float32))], mesh, "stage")
    with pytest.raises(ValueError, match=bad):
        parallel.halo_exchange_left([x] * 8, 1, mesh, "stage")
    g = fir_chain(blocks, Graph, Tag, _rand(0, 4800), [blocks.VectorSink()])
    with pytest.raises(ValueError, match=bad):
        g.run(device="cpu", mesh=mesh, shard_axis="stage")
    with pytest.raises(ValueError, match=bad):
        g.run_stream(chunk_size=2400, device="cpu", mesh=mesh, shard_axis="stage")
    # a 1-D time mesh has no channel axis for the bank's default
    with pytest.raises(ValueError, match=r"no axis 'chan'; its axes are \('time',\)"):
        parallel.sharded_symbol_sync_bank(torch.ones(4, 40), 4.0,
                                          make_mesh(4, device="cpu"))


def test_torch_mesh_2d_indivisible_channels_raise():
    mesh = _mesh((2, 4))  # chan: 4 shards
    with pytest.raises(ValueError, match="channel count 6 must be divisible by 4"):
        parallel.sharded_symbol_sync_bank(torch.ones(6, 40), 4.0, mesh)
    with pytest.raises(ValueError, match="6 channels over 4 shards"):
        parallel.sharded_channelizer_fm(torch.ones(600, dtype=torch.complex64),
                                        parallel.channelizer_taps(6, 4), 6, mesh)


# ---- the six sharded ops and the channelizer bank


@pytest.mark.parametrize("deci", [1, 4])
@pytest.mark.parametrize("axis", ["time", "chan"])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_sharded_fir_matches_jax(jmeshes, shape, axis, deci):
    # atol 1e-4 against JAX, as test_torch_sharded_fir_(decimating_)matches_jax:
    # complex taps at deci 1, float at deci 4
    rng = np.random.RandomState(deci)
    if deci == 1:
        x = _crand(0, 8 * 512)
        t = rng.randn(33).astype(np.float32).astype(np.complex64)
    else:
        x, t = _rand(1, 8 * 512), rng.randn(17).astype(np.float32)
    got = held(lambda m: parallel.sharded_fir_filter(_t(x), t, m, deci=deci, axis=axis),
               _mesh(shape), axis)
    want = np.asarray(jpar.sharded_fir_filter(jnp.asarray(x), t, jmeshes[shape],
                                              deci=deci, axis=axis))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_sharded_fft_filter_matches_jax(jmeshes, shape):
    # atol 3e-3, as test_torch_sharded_fft_filter_matches_jax
    rng = np.random.RandomState(2)
    x = _crand(2, 8 * 1024)
    t = (rng.randn(63) + 1j * rng.randn(63)).astype(np.complex64)
    got = held(lambda m: parallel.sharded_fft_filter(_t(x), t, m), _mesh(shape), "time")
    want = np.asarray(jpar.sharded_fft_filter(jnp.asarray(x), t, jmeshes[shape]))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_sharded_quadrature_demod_matches_jax(jmeshes, shape):
    # atol 1e-5, as test_torch_sharded_quadrature_demod_matches_jax
    x = _crand(3, 8 * 256)
    got = held(lambda m: parallel.sharded_quadrature_demod(_t(x), 0.7, m),
               _mesh(shape), "time")
    want = np.asarray(jpar.sharded_quadrature_demod(jnp.asarray(x), 0.7,
                                                    jmeshes[shape]))
    assert got.shape == (8 * 256,) and float(got[-1]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_sharded_fm_demod_matches_jax(jmeshes, shape):
    # atol 1e-3, as test_torch_sharded_fm_demod_chain_matches_jax
    x = _crand(4, 8 * 2048)
    t = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    got = held(lambda m: parallel.sharded_fm_demod(_t(x), t, m, deci=4),
               _mesh(shape), "time")
    want = np.asarray(jpar.sharded_fm_demod(jnp.asarray(x), t, jmeshes[shape], deci=4))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_sharded_bell202_demod_matches_jax(jmeshes, shape):
    # 2e-3 where the analytic signal is live, as
    # test_torch_sharded_bell202_demod_matches_jax
    from test_torch_parallel import _afsk_audio, _live_inner

    audio = _afsk_audio(8 * 2048, FS, 9)
    got = held(lambda m: parallel.sharded_bell202_demod(_t(audio), FS, m),
               _mesh(shape), "time").numpy()
    want = np.asarray(jpar.sharded_bell202_demod(jnp.asarray(audio), FS,
                                                 jmeshes[shape]))
    m = len(audio) - 1
    assert got.shape == want.shape
    inner = _live_inner(audio, FS)
    assert inner.mean() > 0.95
    np.testing.assert_allclose(got[:m][inner], want[:m][inner], atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_channelizer_bank_matches_jax(jmeshes, shape):
    # atol 1e-5, as test_torch_sharded_channel_bank_matches_jax
    m = 16
    x = _crand(1, 1 << 13)
    h = parallel.channelizer_taps(m, taps_per_branch=4)
    got = held(lambda mesh: parallel.sharded_channelizer_fm(_t(x), h, m, mesh),
               _mesh(shape), "chan")
    want = np.asarray(jbank_fm(x, h, m, jmeshes[shape]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _nrz_bank(seed, c=8, nbits=60, sps=10):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (c, nbits)) * 2.0 - 1.0
    xs = np.repeat(bits, sps, axis=1).astype(np.float32)
    return xs + rng.randn(*xs.shape).astype(np.float32) * 0.05


@pytest.mark.parametrize("method", ["scan", "events"])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_symbol_sync_bank_equals_the_unsharded_bank(shape, method):
    # bit-equal to the unsharded bank, which tests/test_torch_symbol_sync.py
    # holds to the JAX package's; the JAX sharded bank on the 2-D mesh is
    # tests/test_torch_mesh_2d_bank.py (slow)
    xs, sps = _nrz_bank(3), 10.0
    got = held(lambda m: parallel.sharded_symbol_sync_bank(
        _t(xs), sps, m, method=method, return_valid=True), _mesh(shape), "chan")
    one = recover_symbols_batch(_t(xs), sps, method=method, return_valid=True)
    assert bool(got[3].all()) and _same(tuple(got), tuple(one))


# ---- the blocks' mesh segments


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_shard_chain_matches_jax(jmeshes, shape):
    # 1e-5 of max|y| against the offline chain and 1e-3 against JAX, as
    # test_torch_shard_chain's fir_deci4_quad_demod and
    # fft_float_hilbert_quad_demod cases
    lp49 = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
    t21 = np.random.RandomState(10).randn(21).astype(np.float32) / 8
    cases = [(lambda B: [B.FirFilter(lp49, 4), B.QuadratureDemod(0.5)], _crand(1, 3072)),
             (lambda B: [B.FftFilterFloat(t21), B.Hilbert(65), B.QuadratureDemod(1.0)],
              _rand(5, 3072))]
    for make, x in cases:
        got = held(lambda m: shard_chain(make(blocks), m, "time")(_t(x)),
                   _mesh(shape), "time")
        want = _t(x)
        for b in make(blocks):
            want = b.apply(want)
        k = min(got.shape[0], want.shape[0])
        assert k >= want.shape[0] - 2
        scale = max(1.0, float(want.abs().max()))
        assert float((got[:k] - want[:k]).abs().max()) <= 1e-5 * scale
        jgot = np.asarray(jshard_chain(make(jblocks), jmeshes[shape], "time")(
            jnp.asarray(x)))
        assert jgot.shape == tuple(got.shape)
        assert float(np.abs(got.numpy() - jgot).max()) <= 1e-3 * scale


def _run(pkg_blocks, G, T, build, data, mesh, stream=None, **kw):
    sink = pkg_blocks.VectorSink()
    g = build(pkg_blocks, G, T, data, [sink])
    dev = {} if G is jgraph.Graph else {"device": "cpu"}
    if stream:
        g.run_stream(chunk_size=stream, mesh=mesh, **dev, **kw)
    else:
        g.run(mesh=mesh, **dev, **kw)
    return np.asarray(sink.data()), g


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_graph_run_matches_jax(jmeshes, shape):
    # hold_demod at 1e-6, as test_torch_offline_mesh_equals_single
    data = _rand(0, 24000)
    got = held(lambda m: _run(blocks, Graph, Tag, bell, data, m)[0], _mesh(shape),
               "time")
    want, _ = _run(jblocks, jgraph.Graph, None, bell, data, jmeshes[shape])
    hold_demod(got, want, 1e-6)
    plain, _ = _run(blocks, Graph, Tag, bell, data, None)
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis", ["time", "chan"])
@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_run_stream_matches_jax(jmeshes, shape, axis):
    # atol 2e-6, as test_torch_decimating_fir_mesh_offline_and_ragged_stream;
    # the ragged last chunk demotes once, as on the 1-D mesh of the axis
    data = _rand(3, 50001)
    runs = {}

    def stream(m, scan=None):
        out, g = _run(blocks, Graph, Tag, fir_chain, data, m, 9600,
                      shard_axis=axis, scan_chunks=scan)
        runs[(m.grid, scan)] = g.demotions
        return out

    mesh = _mesh(shape)
    got = held(stream, mesh, axis)
    batched = held(lambda m: stream(m, 3), mesh, axis)
    n_sh = mesh.shape[axis]
    for scan in (None, 3):
        assert [(d["chunk"], d["offset"]) for d in runs[(mesh.grid, scan)]] == [(5, 48000)]
        assert runs[(mesh.grid, scan)] == runs[((n_sh,), scan)]
    assert _same(got, batched)
    want, _ = _run(jblocks, jgraph.Graph, None, fir_chain, data, jmeshes[shape], 9600,
                   shard_axis=axis)
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_mesh_2d_checkpoint_resume(jmeshes, shape, tmp_path):
    """A 2-D mesh run paused at a checkpoint and resumed gives the whole
    stream's bits, as on the 1-D mesh of the axis; a JAX 2-D mesh run's
    checkpoint (which records the tails and the count, nothing of the
    mesh's shape) goes on in the port on the 2-D mesh, held to the JAX
    stream at hold_demod's 1e-6 (test_torch_resumes_a_jax_mesh_checkpoint)."""
    from rustradio_tpu_torch.utils.checkpoint import load_checkpoint

    data = _rand(7, 48000)

    def paused(m):
        ck = str(tmp_path / f"port_{m.grid}.ckpt")
        s2, s3 = blocks.VectorSink(), blocks.VectorSink()
        bell(blocks, Graph, Tag, data, [s2]).run_stream(
            chunk_size=8000, mesh=m, max_chunks=3, checkpoint_path=ck,
            checkpoint_every=3, device="cpu")
        bell(blocks, Graph, Tag, data, [s3]).run_stream(
            chunk_size=8000, mesh=m, resume_from=ck, device="cpu")
        return np.concatenate([s2.data(), s3.data()])

    mesh = _mesh(shape)
    got = held(paused, mesh, "time")
    whole, _ = _run(blocks, Graph, Tag, bell, data, mesh, 8000)
    np.testing.assert_array_equal(got, whole)
    ck = str(tmp_path / "jax_2d.ckpt")
    s1 = jblocks.VectorSink()
    bell(jblocks, jgraph.Graph, None, data, [s1]).run_stream(
        chunk_size=8000, mesh=jmeshes[shape], max_chunks=2, checkpoint_path=ck,
        checkpoint_every=2)
    states, offset, extra = load_checkpoint(ck, device="cpu")
    assert extra["mesh"] is True and offset == 16000
    assert set(states["mesh:1"]) == {"tails", "consumed"}
    s2 = blocks.VectorSink()
    bell(blocks, Graph, Tag, data, [s2]).run_stream(
        chunk_size=8000, mesh=mesh, resume_from=ck, device="cpu")
    want, _ = _run(jblocks, jgraph.Graph, None, bell, data, jmeshes[shape], 8000)
    hold_demod(np.concatenate([np.asarray(s1.data()), s2.data()]), want, 1e-6)


@pytest.mark.parametrize("axis", ["time", "chan"])
def test_torch_mesh_2d_run_chunk_carries_every_line(axis):
    """``MeshSegment.run_chunk`` over two chunks on the 2-D mesh: the same
    carries on every line (recorded), bit-equal to the 1-D segment's, and
    the streamed outputs the whole stream's."""
    x = _t(_crand(8, 8 * 512))

    def two_chunks(m):
        ms = chain_segment([blocks.FirFilter(taps.low_pass_complex(
            1_024_000.0, 100_000.0, 50_000.0), 4), blocks.QuadratureDemod(1.0)],
            m, axis)
        carries, outs = ms.init_carries(x), []
        for c in (0, 2048):
            carries, (o,), _ = ms.run_chunk(carries, x[c:c + 2048], c)
            outs.append(o)
        return torch.cat(outs), carries[0]

    got, tail = held(two_chunks, _mesh((4, 2)), axis)
    assert tail.shape == (48,)


def test_torch_mesh_2d_ax25_receiver_from_blocks():
    from rustradio_tpu_torch.models import ax25
    from test_models import make_afsk

    payloads = [b"2-D MESH FRAME ONE", b"2-D MESH FRAME TWO"]
    audio = _t(np.concatenate([make_afsk(p, fs=FS, lead_zeros=500) for p in payloads]))
    mesh = _mesh((4, 2))
    assert ax25.ax25_1200_rx_graph(audio, FS, mesh) == payloads
    assert ax25.ax25_1200_rx_graph(audio, FS, mesh, chunk_size=4096) == payloads


# ---- the stage pipeline


def test_torch_mesh_2d_pipeline_matches_jax():
    # atol 1e-6, as test_torch_pipeline_stages_match_composition: four
    # stages along chan of a (2, 4) mesh, replicated over time
    from test_torch_pipeline import JAX_STAGES, STAGES

    rng = np.random.RandomState(0)
    chunks = rng.randn(7, 256).astype(np.float32)
    got = held(lambda m: parallel.pipeline_run(STAGES, chunks, m, axis="chan"),
               _mesh((2, 4)), "chan")
    theirs = np.asarray(jpar.pipeline_run(JAX_STAGES, chunks, jpar.make_mesh_2d(2, 4),
                                          axis="chan"))
    np.testing.assert_allclose(got.numpy(), theirs, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.tanh(chunks * 2.0 + 1.0) - 0.25,
                               atol=1e-6)
    x = rng.randn(1024).astype(np.float32)
    held(lambda m: parallel.pipeline_chain(STAGES, x, m, 256, axis="chan"),
         _mesh((2, 4)), "chan")
    # rate-changing stages along time of a (2, 4) mesh
    cx = _crand(9, 6 * 1024).reshape(6, 1024)
    stages = [(lambda v: v.reshape(-1, 4).mean(1), 1024, 256),
              (lambda v: ops.quadrature_demod(v, 1.0).to(torch.complex64), 256, 255)]
    got = held(lambda m: parallel.pipeline_run_rates(stages, cx, m, axis="time"),
               _mesh((2, 4)), "time")
    assert got.shape == (6, 255)
