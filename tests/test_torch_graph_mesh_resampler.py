"""The IQ front-end through a rate changer on a mesh — ``FirFilter`` or
``FftFilter`` -> ``RationalResampler`` -> ``QuadratureDemod``, the
reference's examples/ax25-1200-rx.rs:163-188 — as ONE mesh segment of
the port's ``Graph.run`` / ``run_stream(mesh=)``, against the JAX package
(``tests/test_graph_mesh.py``'s resampler cases, their tolerances) on the
8 virtual CPU devices, and against the port's own unsharded run.  The
JAX outputs are computed once per module (``jax_run``); see
``tests/test_torch_graph_mesh.py`` for the conventions.
"""

import numpy as np
import pytest

# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process (~2 s); import it with the module instead, so
# that no test's time holds it
import torch._dynamo  # noqa: F401

from rustradio_tpu import taps as jtaps
from test_torch_graph_mesh import jax_run, meshes, near, run_graph  # noqa: F401

LP50 = np.asarray(jtaps.low_pass(50000.0, 10000.0, 2000.0, "hamming"), np.float32)


def resampler_chain(interp, deci, filt="fir"):
    def build(B, G, T, data, sinks):
        g = G()
        g.chain(B.VectorSource(data),
                B.FirFilter(LP50) if filt == "fir" else B.FftFilter(LP50),
                B.RationalResampler(interp, deci), B.QuadratureDemod(1.0),
                sinks[0])
        return g

    return build


def _crand(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


@pytest.mark.parametrize("interp,deci", [(1, 4), (2, 5), (3, 2), (160, 147)])
def test_torch_resampler_mesh_offline_one_segment(meshes, jax_run, interp, deci):
    data = _crand(5, 40000)
    build = resampler_chain(interp, deci)
    want = jax_run(("off", interp, deci),
                   lambda m: run_graph("jax", build, data, m)[0][0])
    got, g = run_graph("port", build, data, meshes[1])
    plain, _ = run_graph("port", build, data)
    assert got[0].shape == want.shape == plain[0].shape
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=0)
    near(got[0], plain[0], 1e-5)
    # the whole front-end is ONE mesh segment: no split at the rate
    # changer, no demotion
    segs, _, plans = g._segments_mesh(meshes[1], "time")
    assert len(plans) == 1 and len(segs[next(iter(plans))]) == 3
    assert g.demotions == []


def test_torch_resampler_mesh_fft_filter_front(meshes, jax_run):
    # the FFT filter's ramp-in makes the first demod samples ill-conditioned
    # (angles of ~1e-10-magnitude products): compared past it, as JAX does
    data = _crand(8, 40000)
    build = resampler_chain(2, 5, "fft")
    want = jax_run("fft", lambda m: run_graph("jax", build, data, m)[0][0])
    got, _ = run_graph("port", build, data, meshes[1])
    plain, _ = run_graph("port", build, data)
    assert got[0].shape == want.shape == plain[0].shape
    np.testing.assert_allclose(got[0][32:], want[32:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[0][32:], plain[0][32:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunk", [8000, 7003])
def test_torch_resampler_mesh_streaming(meshes, jax_run, chunk):
    # 8000 divides the mesh grid (sharded until the ragged end); 7003 does
    # not (the first chunk demotes, and the members run unsharded with the
    # resampler's host offsets)
    data = _crand(6, 40013)
    build = resampler_chain(2, 5)
    want = jax_run(("stream", chunk),
                   lambda m: run_graph("jax", build, data, m, chunk)[0][0])
    got, g = run_graph("port", build, data, meshes[1], chunk)
    plain, _ = run_graph("port", build, data, None, chunk)
    assert got[0].shape == want.shape == plain[0].shape
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=0)
    near(got[0], plain[0], 1e-5)
    assert [d["chunk"] for d in g.demotions] == ([5] if chunk == 8000 else [0])


def test_torch_resampler_mesh_scan_runner(meshes, jax_run):
    # batches over the mesh segment holding the rate changer; the last
    # chunk (4000 = 100 x 8 shards x div 5) runs sharded too.  Held against the JAX mesh run
    # per chunk: JAX's own scan run reassociates f32 ops (XLA) and sits
    # 8.1e-6 from it, while the port's batches are its per-chunk run bit
    # for bit
    data = _crand(7, 44000)
    build = resampler_chain(2, 5)
    want = jax_run("scan", lambda m: run_graph("jax", build, data, m, 8000)[0][0])
    got, g = run_graph("port", build, data, meshes[1], 8000, scan_chunks=4)
    per_chunk, _ = run_graph("port", build, data, meshes[1], 8000)
    plain, _ = run_graph("port", build, data, None, 8000)
    assert got[0].shape == want.shape == plain[0].shape
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0], per_chunk[0])
    near(got[0], plain[0], 1e-5)
    assert g.demotions == []


def test_torch_resumes_a_demoted_jax_mesh_checkpoint(meshes, jax_run, tmp_path):
    """A JAX mesh run whose segment demoted at its first chunk (7003 does
    not divide the grid), paused at a checkpoint: its ``{"demoted": True}``
    state stays a host value, the resampler's offsets host ints, and the
    port goes on unsharded from there to the JAX run's stream."""
    import rustradio_tpu.blocks as jblocks
    import rustradio_tpu.graph as jgraph
    from rustradio_tpu.streams import Tag as JTag
    from rustradio_tpu_torch import blocks
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.streams import Tag
    from rustradio_tpu_torch.utils.checkpoint import load_checkpoint

    data = _crand(6, 40013)
    build = resampler_chain(2, 5)
    want = jax_run(("stream", 7003),
                   lambda m: run_graph("jax", build, data, m, 7003)[0][0])
    ck = str(tmp_path / "demoted.ckpt")
    s1 = jblocks.VectorSink()
    build(jblocks, jgraph.Graph, JTag, data, [s1]).run_stream(
        chunk_size=7003, mesh=meshes[0], max_chunks=2, checkpoint_path=ck,
        checkpoint_every=2)
    states, offset, _ = load_checkpoint(ck, device="cpu")
    assert states["mesh:1"] == {"demoted": True} and offset == 14006
    assert states[2] == {"in_off": 14006 - len(LP50) + 1,
                         "out_off": -(-(14006 - len(LP50) + 1) * 2 // 5)}
    s2 = blocks.VectorSink()
    g = Graph()
    build(blocks, lambda: g, Tag, data, [s2])
    g.run_stream(chunk_size=7003, mesh=meshes[1], resume_from=ck, device="cpu")
    assert g.demotions == []  # demoted before the checkpoint
    got = np.concatenate([np.asarray(s1.data()), s2.data()])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
