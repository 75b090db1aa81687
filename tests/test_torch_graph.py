"""The port's Graph, blocks and FM lowering against the JAX package.

The port lowers FirFilter -> QuadratureDemod to one kernel-B pass on
every device (on the CPU through its plain version); the JAX Graph on the
CPU runs the composed ops, or the windowed Pallas kernel in interpret
mode for the packed ring.  Inputs come from numpy RandomStates.
"""

import numpy as np
import pytest
import torch

import rustradio_tpu.ops.pallas_kernels as pk
from rustradio_tpu import blocks as jblocks
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu_torch import blocks, convert, lowering
from rustradio_tpu_torch.graph import Graph
from test_pallas_interpret import _demod_f64, _fir_valid_f64


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _fm_graph(mod, graph_cls, data, taps, deci, gain, sink, planes=False):
    g = graph_cls()
    if planes:
        src_r = g.add(mod.VectorSource(np.real(data).astype(np.float32)))
        src_i = g.add(mod.VectorSource(np.imag(data).astype(np.float32)))
        x = g.add(mod.FloatToComplex(), src_r, src_i)
    else:
        x = g.add(mod.VectorSource(data))
    fir = g.add(mod.FirFilter(taps, deci=deci), x)
    q = g.add(mod.QuadratureDemod(gain), fir)
    g.add(sink, q)
    return g


@pytest.mark.parametrize("planes", [False, True])
def test_torch_graph_offline_matches_jax(planes):
    rng = np.random.RandomState(60)
    taps = (rng.randn(49) / 7).astype(np.float32)
    n = 4096
    data = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    js, ps = jblocks.VectorSink(), blocks.VectorSink()
    _fm_graph(jblocks, JGraph, data, taps, 4, 2.5, js, planes).run()
    g = _fm_graph(blocks, Graph, data, taps, 4, 2.5, ps, planes)
    seg = next(iter(g._segments().values()))
    plans, consumed = lowering.find_fm_pairs(seg, set())
    assert len(plans) == 1 and len(consumed) == (3 if planes else 2)
    g.run(device="cpu")
    want = np.asarray(js.data())
    got = ps.data()
    assert got.shape == want.shape
    # lowered kernel numerics (fast atan2) against JAX's composed CPU ops:
    # the reference lowering's own budget (test_pallas_interpret.py:222)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    np.testing.assert_allclose(
        got, _demod_f64(_fir_valid_f64(data, taps, 4), 2.5), atol=3e-4, rtol=0)
    # stream tags survive the fused segment, rescaled like the reference's
    assert [(t.pos, t.key) for t in ps.tags()] == [
        (t.pos, t.key) for t in js.tags()]


def test_torch_graph_unfused_fir_matches_jax():
    # FirFilter -> VectorSink: no FM pair, the block's own apply runs
    rng = np.random.RandomState(61)
    taps = rng.randn(33).astype(np.float32) / 5
    data = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    jf, pf = jblocks.VectorSink(), blocks.VectorSink()
    for mod, graph_cls, s, kw in [(jblocks, JGraph, jf, {}),
                                  (blocks, Graph, pf, {"device": "cpu"})]:
        g = graph_cls()
        g.chain(mod.VectorSource(data), mod.FirFilter(taps, deci=2), s)
        g.run(**kw)
    np.testing.assert_allclose(pf.data(), np.asarray(jf.data()),
                               atol=2e-5 * np.abs(jf.data()).max(), rtol=0)


def test_torch_packed_ring_device_loop_matches_jax(interpret_kernels):
    # the ring case of test_pallas_interpret.py:302-336 in both packages
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    taps = (rng.randn(49) / 7).astype(np.float32)  # (49-1) % 4 == 0
    deci, tile_rows = 4, 16
    chunk = deci * 128 * tile_rows
    n = 2 * chunk
    re = (np.round(np.clip(rng.randn(n) * 38, -128, 127)) / 128).astype(np.float32)
    im = (np.round(np.clip(rng.randn(n) * 38, -128, 127)) / 128).astype(np.float32)

    def build(mod, graph_cls, fold):
        g = graph_cls()
        src = g.add(mod.PackedIqRingSource(re, im, taps, deci, precision="w3",
                                           tile_rows=tile_rows))
        fir = g.add(mod.FirFilter(taps, deci=deci, precision="w3"), src)
        q = g.add(mod.QuadratureDemod(1.5), fir)
        g.add(mod.DeviceFoldSink(fn=fold), q)
        return g

    jfn = build(jblocks, JGraph,
                lambda c, x: c + jnp.sum(x) + jnp.sum(x * x)
                ).compile_device_loop(chunk, 2)
    want_jax = float(list(jfn(0).values())[0])
    fn = build(blocks, Graph, lambda c, x: c + x.sum() + (x * x).sum()
               ).compile_device_loop(chunk, 2, device="cpu")
    got = float(list(fn(0).values())[0])

    want = _demod_f64(_fir_valid_f64(re + 1j * im, taps, deci), 1.5)
    ref = float(np.sum(want) + np.sum(want * want))
    # the reference test's tolerance (f32 folds of the fast-atan2 stream)
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    np.testing.assert_allclose(got, want_jax, rtol=2e-3)


def test_torch_device_loop_rejects_misaligned_offset():
    g = Graph()
    g.chain(blocks.VectorSource(np.zeros(4096, np.complex64)),
            blocks.FirFilter(np.ones(5, np.float32), deci=4),
            blocks.QuadratureDemod(1.0), blocks.DeviceFoldSink())
    fn = g.compile_device_loop(1024, 2, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of chunk_size"):
        fn(512)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        g.compile_device_loop(1000, 2, device="cpu")
    fn(1024)  # aligned offsets run


@pytest.mark.parametrize("planes", [False, True])
def test_torch_device_loop_equals_offline(planes):
    # the chunked, lowered stream over carried states equals the offline
    # stream; the two-source form (planes=True) also guards against a loop
    # variable replaying chunk 0 for the second source
    rng = np.random.RandomState(62)
    taps = (rng.randn(49) / 7).astype(np.float32)
    chunk = 2048
    data = (rng.randn(4 * chunk) + 1j * rng.randn(4 * chunk)).astype(np.complex64)
    off = blocks.DeviceFoldSink()
    _fm_graph(blocks, Graph, data, taps, 4, 1.0, off, planes).run(device="cpu")
    fn = _fm_graph(blocks, Graph, data, taps, 4, 1.0, blocks.DeviceFoldSink(),
                   planes).compile_device_loop(chunk, 4, device="cpu")
    got = float(list(fn(0).values())[0])
    # f32 fold of 2047 outputs per chunk against the offline f64 total
    np.testing.assert_allclose(got, off.total(), rtol=1e-5, atol=1e-3)


def test_torch_device_loop_on_the_cpu_is_the_plain_loop():
    # no CUDA graph off the card: every call runs the loop from fresh
    # states, whatever ``cuda_graph`` says, and launches no kernel
    from rustradio_tpu_torch.ops import kernels

    rng = np.random.RandomState(64)
    taps = (rng.randn(49) / 7).astype(np.float32)
    chunk = 1024
    data = (rng.randn(4 * chunk) + 1j * rng.randn(4 * chunk)).astype(np.complex64)
    before = dict(kernels.LAUNCHES)
    folds = []
    for cuda_graph in (True, False):
        g = _fm_graph(blocks, Graph, data, taps, 4, 1.0, blocks.DeviceFoldSink())
        fn = g.compile_device_loop(chunk, 2, device="cpu", cuda_graph=cuda_graph)
        folds += [fn(0), fn(0), fn(2 * chunk), fn(0)]
    vals = [float(next(iter(f.values()))) for f in folds]
    assert vals[0] == vals[1] == vals[3] == vals[4] == vals[5] == vals[7]
    assert vals[2] == vals[6] and vals[2] != vals[0]
    assert kernels.LAUNCHES == before


def test_torch_resume_from_jax_state():
    # chunk 0 in JAX, its block states carried across, chunk 1 in the port
    rng = np.random.RandomState(63)
    taps = (rng.randn(49) / 7).astype(np.float32)
    c0 = (rng.randn(3001) + 1j * rng.randn(3001)).astype(np.complex64)
    c1 = (rng.randn(2999) + 1j * rng.randn(2999)).astype(np.complex64)
    jf, jq = jblocks.FirFilter(taps, deci=4), jblocks.QuadratureDemod(1.2)
    sf, y0 = jf.apply_chunk(jf.init_state(), c0)
    sq, _ = jq.apply_chunk(jq.init_state(), y0)
    _, y1 = jf.apply_chunk(sf, c1)
    _, want = jq.apply_chunk(sq, y1)
    want = np.asarray(want)

    st = convert.state_from_jax(
        {"fir": {"buf": np.asarray(sf["buf"]), "out_off": sf["out_off"]},
         "quad": np.asarray(sq)})
    assert isinstance(st["fir"]["out_off"], int)
    x1 = torch.from_numpy(c1)

    # the port's blocks, unlowered
    pf, pq = blocks.FirFilter(taps, deci=4), blocks.QuadratureDemod(1.2)
    sf2, y = pf.apply_chunk(st["fir"], x1)
    _, got = pq.apply_chunk(st["quad"], y)
    assert sf2["out_off"] == jf.apply_chunk(sf, c1)[0]["out_off"]
    # f32 direct FIR vs f32 conv, exact atan2 in both (the reference's
    # streaming-equals-offline budget)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    # the lowered streaming form over the same carried states
    g = Graph()
    g.chain(blocks.VectorSource(c1), pf, pq, blocks.VectorSink())
    plans, _ = lowering.find_fm_pairs(next(iter(g._segments().values())), set())
    plan = next(iter(plans.values()))
    new_fir, new_quad, got2 = lowering.fused_fm_chunk(plan, st["fir"],
                                                      st["quad"], x1)
    assert new_fir["out_off"] == sf2["out_off"]
    assert torch.equal(new_fir["buf"], sf2["buf"])
    np.testing.assert_allclose(got2.numpy(), want, atol=3e-4, rtol=0)
