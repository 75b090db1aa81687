"""``Graph.run`` / ``Graph.run_stream(mesh=)`` of the port against the JAX
package's (``tests/test_graph_mesh.py``): the same block flowgraphs on the
same numpy inputs from one seed, the JAX graph on the 8 virtual CPU
devices ``tests/conftest.py`` forces, the port's on
``make_mesh(8, device="cpu")``.  Each comparison keeps the JAX test's
tolerance against the JAX mesh run; each port mesh run is also held
against the port's own unsharded run: bit for bit where every output is
the same arithmetic on the same samples (the digital chain, the tags,
the resampler's gathers), else at the JAX test's tolerance of max|y|: a
CPU ``conv1d`` sums in an order that depends on the tensor's length, so a
shard's filter rounds apart from the whole stream's in the last ulps (on
the card kernel A's sum for an output does not depend on where its tile
starts), and the exact discriminator turns a last-ulp difference at a
near-zero sample into another angle.  The JAX test's
tolerance bounds a mesh run against a single-device run; against the JAX
package, the chains through the discriminator differ by up to 1.7e-6
already unsharded, in the filters' ramp-in only (the two packages' filters
round apart where the analytic signal is near zero), so ``hold_demod``
holds them at the JAX test's tolerance past the ramp-in and at
``XPKG_DEMOD`` within it — ``tests/test_torch_stream.py`` holds the same
chain at 1e-4.  The JAX outputs are computed once per module
(``jax_run``).

Also: the demotions of a run (none on full divisible chunks, one at a
ragged end), a mesh on the wrong device, checkpoints of a mesh run (the
port's and the JAX package's, resumed in the port), and the shard
positions past 2^30 (``MeshSegment.run_chunk`` of the resampler).
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
from rustradio_tpu.parallel import graph_mesh as jgm
from rustradio_tpu.streams import Tag as JTag
from rustradio_tpu_torch import blocks
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.parallel import make_mesh
from rustradio_tpu_torch.parallel.graph_mesh import chain_segment
from rustradio_tpu_torch.streams import Tag

N_DEV = 8
XPKG_DEMOD = 1e-5  # port against JAX in the bell chain's ramp-in (docstring)
PACKAGES = {"jax": (jblocks, jgraph.Graph, JTag), "port": (blocks, Graph, Tag)}


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= N_DEV, "conftest should force 8 CPU devices"
    return jpar.make_mesh(N_DEV), make_mesh(N_DEV, device="cpu")


@pytest.fixture(scope="module")
def jax_run(meshes):
    """``jax_run(key, fn)``: the JAX package's result of ``fn(jax mesh)``,
    computed once per module."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn(meshes[0])
        return cache[key]

    return get


def run_graph(pkg, build, data, mesh=None, stream=None, **kw):
    """Build the graph with ``pkg``'s blocks (``build(B, G, T, data,
    sinks)``), run it offline or streamed in chunks of ``stream``, and
    return (the sinks' data, the graph)."""
    B, G, T = PACKAGES[pkg]
    sinks = [B.VectorSink() for _ in range(getattr(build, "n_sinks", 1))]
    g = build(B, G, T, data, sinks)
    dev = {} if pkg == "jax" else {"device": "cpu"}
    if stream:
        g.run_stream(chunk_size=stream, mesh=mesh, **dev, **kw)
    else:
        g.run(mesh=mesh, **dev)
    return [np.asarray(s.data()) for s in sinks], g


def near(got, want, tol):
    """Within ``tol`` of max|want| and of the same shape: the port's mesh
    run against its own unsharded run through a CPU ``conv1d``."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0)


BP = np.asarray(jtaps.band_pass(24000.0, 400.0, 2700.0, 65, "hamming"), np.float32)
LP = np.asarray(jtaps.low_pass(24000.0, 1100.0, 200.0, "hamming"), np.float32)
LP48 = np.asarray(jtaps.low_pass(48000.0, 8000.0, 2000.0, "hamming"), np.float32)
LPC = np.asarray(jtaps.low_pass_complex(48000.0, 8000.0, 2000.0, "hamming"))


def hold_demod(got, want, tol):
    """The port against the JAX package through the bell chain's
    discriminator: ``tol`` (the JAX test's) past the filters' ramp-in
    (their taps' total length), ``XPKG_DEMOD`` within it."""
    ramp = len(BP) + 65 + len(LP)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[ramp:], want[ramp:], atol=tol, rtol=0)
    np.testing.assert_allclose(got, want, atol=max(tol, XPKG_DEMOD), rtol=0)


def bell(B, G, T, data, sinks):
    g = G()
    g.chain(B.VectorSource(data), B.FftFilterFloat(BP), B.Hilbert(65),
            B.QuadratureDemod(1.0), B.FftFilterFloat(LP), B.AddConst(-0.3),
            sinks[0])
    return g


def fir_chain(B, G, T, data, sinks):
    g = G()
    g.chain(B.VectorSource(data), B.FirFilter(LP48, deci=4), B.MultiplyConst(2.0),
            B.FirFilter(np.ones(5, np.float32) / 5, deci=3), sinks[0])
    return g


def _rand(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _crand(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def test_torch_offline_mesh_equals_single(meshes, jax_run):
    data = _rand(0, 48000)
    want = jax_run("offline", lambda m: run_graph("jax", bell, data, m)[0][0])
    got, g = run_graph("port", bell, data, meshes[1])
    plain, _ = run_graph("port", bell, data)
    assert got[0].shape == want.shape == plain[0].shape
    hold_demod(got[0], want, 1e-6)
    np.testing.assert_allclose(got[0], plain[0], atol=1e-6, rtol=0)
    assert g.demotions == []


def test_torch_streaming_mesh_equals_single(meshes, jax_run):
    data = _rand(1, 48000)
    want = jax_run("stream", lambda m: run_graph("jax", bell, data, m, 8000)[0][0])
    got, g = run_graph("port", bell, data, meshes[1], 8000)
    plain, _ = run_graph("port", bell, data, None, 8000)
    hold_demod(got[0], want, 1e-6)
    np.testing.assert_allclose(got[0], plain[0], atol=1e-6, rtol=0)
    # six full chunks of 8000 = 8 x 1000: the segment never demotes
    assert g.demotions == []


def test_torch_offline_mesh_odd_length_pads_and_trims(meshes, jax_run):
    data = _rand(2, 10007)
    want = jax_run("odd", lambda m: run_graph("jax", bell, data, m)[0][0])
    got, _ = run_graph("port", bell, data, meshes[1])
    plain, _ = run_graph("port", bell, data)
    assert got[0].shape == want.shape == plain[0].shape
    hold_demod(got[0], want, 1e-6)
    np.testing.assert_allclose(got[0], plain[0], atol=1e-6, rtol=0)


def test_torch_decimating_fir_mesh_offline_and_ragged_stream(meshes, jax_run):
    data = _rand(3, 50001)
    want = jax_run("fir", lambda m: [run_graph("jax", fir_chain, data, m)[0][0],
                                     run_graph("jax", fir_chain, data, m, 9600)[0][0]])
    off, _ = run_graph("port", fir_chain, data, meshes[1])
    st, g = run_graph("port", fir_chain, data, meshes[1], 9600)
    plain_off, _ = run_graph("port", fir_chain, data)
    plain_st, _ = run_graph("port", fir_chain, data, None, 9600)
    for got, w in ((off[0], want[0]), (st[0], want[1])):
        assert got.shape == w.shape
        np.testing.assert_allclose(got, w, atol=2e-6)
    near(off[0], plain_off[0], 2e-6)
    near(st[0], plain_st[0], 2e-6)
    # 50001 = 5 x 9600 + 2001: the ragged last chunk demotes, once
    assert [(d["chunk"], d["offset"]) for d in g.demotions] == [(5, 48000)]


def test_torch_translating_fir_mesh(meshes, jax_run):
    data = _crand(4, 24000)

    def build(B, G, T, x, sinks):
        g = G()
        g.chain(B.VectorSource(x),
                B.FirFilter(LPC, deci=2, translate=(48000.0, 12000.0)), sinks[0])
        return g

    want = jax_run("translate", lambda m: [run_graph("jax", build, data)[0][0],
                                           run_graph("jax", build, data, m)[0][0],
                                           run_graph("jax", build, data, m, 4800)[0][0]])
    off, _ = run_graph("port", build, data, meshes[1])
    st, _ = run_graph("port", build, data, meshes[1], 4800)
    plain, _ = run_graph("port", build, data)
    for got, w in ((off[0], want[1]), (st[0], want[2])):
        np.testing.assert_allclose(got, w, atol=2e-4)
        np.testing.assert_allclose(got, want[0], atol=2e-4)
        np.testing.assert_allclose(got, plain[0], atol=2e-4)


def test_torch_digital_chain_mesh(meshes, jax_run):
    data = _rand(5, 4096)

    def build(B, G, T, x, sinks):
        g = G()
        g.chain(B.VectorSource(x), B.BinarySlicer(), B.NrziDecode(),
                B.Descrambler.g3ruh(), sinks[0])
        return g

    want = jax_run("digital", lambda m: [run_graph("jax", build, data, m)[0][0],
                                         run_graph("jax", build, data, m, 1024)[0][0]])
    plain, _ = run_graph("port", build, data)
    for got, w in ((run_graph("port", build, data, meshes[1])[0][0], want[0]),
                   (run_graph("port", build, data, meshes[1], 1024)[0][0], want[1])):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, plain[0])


def test_torch_mesh_tags_rescale(meshes, jax_run):
    data = _rand(6, 9600)

    def build(B, G, T, x, sinks):
        g = G()
        g.chain(B.VectorSource(x, tags=[T(1000, "mark", 1), T(5000, "mark", 2)]),
                B.FirFilter(np.ones(9, np.float32) / 9, deci=4), sinks[0])
        return g

    def marks(g_sinks):
        return [(t.pos, t.key, t.val) for t in g_sinks if t.key == "mark"]

    def jax_tags(m):
        B, G, T = PACKAGES["jax"]
        s = B.VectorSink()
        build(B, G, T, data, [s]).run_stream(chunk_size=2400, mesh=m)
        return marks(s.tags())

    want = jax_run("tags", jax_tags)
    for mesh in (meshes[1], None):
        s = blocks.VectorSink()
        build(blocks, Graph, Tag, data, [s]).run_stream(chunk_size=2400, mesh=mesh,
                                                        device="cpu")
        # chunk-relative positions, rescaled by 1/4, plus the sink's count
        assert marks(s.tags()) == want == [(250, "mark", 1), (1248, "mark", 2)]


def test_torch_mesh_checkpoint_resume(meshes, jax_run, tmp_path):
    data = _rand(7, 48000)
    ck = str(tmp_path / "mesh.ckpt")
    want = jax_run("ckpt", lambda m: run_graph("jax", bell, data, m, 8000)[0][0])
    whole, _ = run_graph("port", bell, data, meshes[1], 8000)
    s2 = blocks.VectorSink()
    bell(blocks, Graph, Tag, data, [s2]).run_stream(
        chunk_size=8000, mesh=meshes[1], max_chunks=3, checkpoint_path=ck,
        checkpoint_every=3, device="cpu")
    s3 = blocks.VectorSink()
    bell(blocks, Graph, Tag, data, [s3]).run_stream(
        chunk_size=8000, mesh=meshes[1], resume_from=ck, device="cpu")
    got = np.concatenate([s2.data(), s3.data()])
    np.testing.assert_array_equal(got, whole[0])
    hold_demod(got, want, 1e-6)
    # mode mismatch is an error, both ways
    with pytest.raises(ValueError, match="mesh"):
        bell(blocks, Graph, Tag, data, [blocks.VectorSink()]).run_stream(
            chunk_size=8000, resume_from=ck, device="cpu")
    plain_ck = str(tmp_path / "plain.ckpt")
    bell(blocks, Graph, Tag, data, [blocks.VectorSink()]).run_stream(
        chunk_size=8000, max_chunks=2, checkpoint_path=plain_ck,
        checkpoint_every=2, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        bell(blocks, Graph, Tag, data, [blocks.VectorSink()]).run_stream(
            chunk_size=8000, resume_from=plain_ck, mesh=meshes[1], device="cpu")


def test_torch_resumes_a_jax_mesh_checkpoint(meshes, jax_run, tmp_path):
    """A JAX mesh run paused at a checkpoint goes on in the port: its tails
    become tensors on the mesh's first device, ``consumed`` a host int."""
    from rustradio_tpu_torch.utils.checkpoint import load_checkpoint

    data = _rand(7, 48000)
    ck = str(tmp_path / "jax_mesh.ckpt")
    want = jax_run("ckpt", lambda m: run_graph("jax", bell, data, m, 8000)[0][0])
    s1 = jblocks.VectorSink()
    bell(jblocks, jgraph.Graph, JTag, data, [s1]).run_stream(
        chunk_size=8000, mesh=meshes[0], max_chunks=2, checkpoint_path=ck,
        checkpoint_every=2)
    states, offset, extra = load_checkpoint(ck, device="cpu")
    assert extra["mesh"] is True and offset == 16000
    mst = states["mesh:1"]
    assert mst["consumed"] == 16000 and isinstance(mst["consumed"], int)
    assert all(torch.is_tensor(t) and t.device.type == "cpu"
               for t in mst["tails"].values())
    s2 = blocks.VectorSink()
    bell(blocks, Graph, Tag, data, [s2]).run_stream(
        chunk_size=8000, mesh=meshes[1], resume_from=ck, device="cpu")
    got = np.concatenate([np.asarray(s1.data()), s2.data()])
    hold_demod(got, want, 1e-6)


def test_torch_mesh_scan_chunks_fir_deci(meshes, jax_run):
    data = _rand(9, 96000)
    want = jax_run("scan_fir", lambda m: run_graph(
        "jax", fir_chain, data, m, 9600, scan_chunks=4)[0][0])
    got, g = run_graph("port", fir_chain, data, meshes[1], 9600, scan_chunks=4)
    per_chunk, _ = run_graph("port", fir_chain, data, meshes[1], 9600)
    plain, _ = run_graph("port", fir_chain, data, None, 9600)
    np.testing.assert_allclose(got[0], want, atol=2e-6)
    np.testing.assert_array_equal(got[0], per_chunk[0])
    near(got[0], plain[0], 2e-6)
    assert g.demotions == []  # 10 full chunks: 1 alone, then 4, 4 and 1


def test_torch_mesh_fanout_tee(meshes, jax_run):
    data = _rand(10, 19200)

    def build(B, G, T, x, sinks):
        g = G()
        src = g.add(B.VectorSource(x))
        f = g.add(B.FirFilter(np.ones(9, np.float32) / 9, deci=4), src)
        t = g.add(B.Tee(), f)
        g.add(sinks[0], t[0])
        g.add(sinks[1], g.add(B.MultiplyConst(3.0), t[1]))
        return g

    build.n_sinks = 2
    want = jax_run("tee", lambda m: run_graph("jax", build, data, m)[0])
    got, _ = run_graph("port", build, data, meshes[1])
    plain, _ = run_graph("port", build, data)
    for a, w, p in zip(got, want, plain):
        np.testing.assert_allclose(a, w, atol=1e-6)
        near(a, p, 1e-6)


def test_torch_mesh_diamond_add(meshes, jax_run):
    data = _rand(11, 19200)

    def build(B, G, T, x, sinks):
        g = G()
        src = g.add(B.VectorSource(x))
        t = g.add(B.Tee(), src)
        a = g.add(B.MultiplyConst(0.5), t[0])
        b = g.add(B.FftFilterFloat(np.ones(7, np.float32) / 7), t[1])
        g.add(sinks[0], g.add(B.Add(), a, b))
        return g

    want = jax_run("diamond", lambda m: [run_graph("jax", build, data, m)[0][0],
                                         run_graph("jax", build, data, m, 4800)[0][0]])
    plain, _ = run_graph("port", build, data)
    for got, w in ((run_graph("port", build, data, meshes[1])[0][0], want[0]),
                   (run_graph("port", build, data, meshes[1], 4800)[0][0], want[1])):
        np.testing.assert_allclose(got, w, atol=1e-6)
        near(got, plain[0], 1e-6)


def test_torch_mesh_demotions_are_counted(meshes):
    """None on a stream of full divisible chunks (per chunk and batched),
    exactly one at a ragged end, and one for a stream too short to shard
    offline; the ragged run's output is the unsharded run's."""
    mesh = meshes[1]
    for n, scan, want in ((38400, None, []), (38400, 2, []),
                          (41000, None, [4]), (41000, 2, [4])):
        _, g = run_graph("port", fir_chain, _rand(12, n), mesh, 9600,
                         scan_chunks=scan)
        assert [d["chunk"] for d in g.demotions] == want, (n, scan, g.demotions)
    data = _rand(12, 41000)
    got, _ = run_graph("port", fir_chain, data, mesh, 9600, scan_chunks=2)
    plain, _ = run_graph("port", fir_chain, data, None, 9600)
    near(got[0], plain[0], 2e-6)
    short = _rand(13, 100)
    got, g = run_graph("port", fir_chain, short, mesh)
    assert [d["chunk"] for d in g.demotions] == [None]
    np.testing.assert_array_equal(got[0], run_graph("port", fir_chain, short)[0][0])


def test_torch_mesh_must_sit_on_the_run_device(meshes):
    g = fir_chain(blocks, Graph, Tag, _rand(14, 4800), [blocks.VectorSink()])
    with pytest.raises(ValueError, match="mesh starts on"):
        g.run(device="meta", mesh=meshes[1])
    with pytest.raises(ValueError, match="mesh starts on"):
        g.run_stream(chunk_size=2400, device="meta", mesh=meshes[1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_torch_cuda_mesh_without_a_card_raises():
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh(4, device="cuda:0")
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh(4)


def test_torch_positions_past_2_30_keep_the_resampler_grid(meshes):
    """The port's shard positions are exact host ints: ``run_chunk`` at two
    stream positions past 2^30 that differ mod the resampler's period
    gives each the unsharded ``RationalResampler`` advanced to there.  The
    JAX form clamps the position to 2^30 (``graph_mesh.py:379``), so its
    two outputs are the same (ROADMAP queue 3, item 13)."""
    jmesh, mesh = meshes
    x = _crand(15, 8 * 5 * 64)
    c1 = (1 << 30) + 8 * 5 * 1000
    outs = {}
    for c in (c1, c1 + 3):  # period 10
        rs = blocks.RationalResampler(2, 5)
        ms = chain_segment([rs], mesh)
        _, (got,), lens = ms.run_chunk({}, torch.from_numpy(x), c)
        _, want = rs.apply_chunk(rs.shard_state(None, c), torch.from_numpy(x))
        assert lens == [x.shape[0] * 2 // 5]
        assert torch.equal(got, want)
        outs[c] = got
        node = jgm._Node(jblocks.RationalResampler(2, 5), 0)
        node.inputs = [jgm._Port(jgm._Node(None, -1))]
        jms = jgm.MeshSegment([node], [(-1, 0)], [(0, 0)], jmesh, "time")
        _, (jgot,), _ = jms.run_chunk(jms.init_carries(x), jnp.asarray(x), c)
        outs[("jax", c)] = np.asarray(jgot)
    assert not torch.equal(outs[c1], outs[c1 + 3])
    np.testing.assert_array_equal(outs[("jax", c1)], outs[("jax", c1 + 3)])


def test_torch_mesh_segments_are_traced_timed_and_costed(meshes, tmp_path):
    """A mesh segment's calls carry ``rr::mesh:<name>`` regions in a
    ``profile_dir`` trace, per chunk and batched, and count into
    ``generate_stats()`` and ``costs()`` (on its first member) as a
    segment does."""
    import glob
    import json

    data = _rand(16, 38400)
    for scan in (None, 2):
        d = tmp_path / f"trace_{scan}"
        g = fir_chain(blocks, Graph, Tag, data, [blocks.VectorSink()])
        g.run_stream(chunk_size=9600, device="cpu", mesh=meshes[1],
                     scan_chunks=scan, profile_dir=str(d))
        (path,) = glob.glob(str(d) + "/*.json")
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert "rr::mesh:FirFilter+MultiplyConst+FirFilter" in names
        assert g.costs()[1]["bytes"] > 0 and {2, 3}.isdisjoint(g.costs())
        rows = {r.split()[0]: r.split() for r in g.generate_stats().splitlines()}
        assert float(rows["FirFilter"][1]) > 0 and "GFLOP" in g.generate_stats()
