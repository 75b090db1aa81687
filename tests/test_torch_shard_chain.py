"""The blocks' shard plans: ``parallel.graph_mesh.shard_chain`` over 8
shards on the CPU against the port's offline block chain, for every block
class that declares a plan, and against the JAX package's ``shard_chain``
(on the 8 virtual CPU devices of ``tests/conftest.py``) where the JAX
block exists; and ``NotShardable`` for what cannot be planned.
"""

import jax
import numpy as np
import pytest
import torch

import rustradio_tpu.blocks as jblocks
import rustradio_tpu.parallel as jpar
from rustradio_tpu.parallel.graph_mesh import shard_chain as jshard_chain
from rustradio_tpu_torch import blocks, taps
from rustradio_tpu_torch.parallel import make_mesh
from rustradio_tpu_torch.parallel.graph_mesh import (
    MeshSegment,
    NotShardable,
    _Node,
    _Port,
    shard_chain,
)

N_DEV = 8
N = N_DEV * 384  # divisible by every case's shards x div


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, device="cpu")


def _complex(seed, n=N):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _float(seed, n=N):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _offline(chain, x):
    y = x
    for b in chain:
        y = b.apply(y)
        if isinstance(y, tuple):
            y = y[0]
    return y


LP49 = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
T17 = np.random.RandomState(7).randn(17).astype(np.float32)
T31C = (np.random.RandomState(8).randn(31)
        + 1j * np.random.RandomState(9).randn(31)).astype(np.complex64)
T21 = np.random.RandomState(10).randn(21).astype(np.float32) / 8
T10 = np.random.RandomState(11).randn(10).astype(np.float32) / 4
CODE1 = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8)   # begins with a one
CODE0 = np.array([0, 0, 0, 1, 1, 0, 1, 0], np.uint8)   # begins with zeros

# (name, chain factory over a blocks module, input, tolerance of |error| /
# max(1, max|offline|) against the offline chain, the same against JAX or
# None where the JAX block is missing or differs)
CASES = [
    ("fir", lambda B: [B.FirFilter(T17)], _float(0), 2e-5, 1e-4),
    ("fir_deci4_quad_demod", lambda B: [B.FirFilter(LP49, 4), B.QuadratureDemod(0.5)],
     _complex(1), 1e-5, 1e-3),
    ("fir_translating", lambda B: [B.FirFilter(LP49, 2, translate=(48_000.0, 3_000.0))],
     _complex(2), 2e-5, 1e-4),
    # behind a drop of 9: the window grid and the rotator's phase move with it
    ("fir_translating_after_fir",
     lambda B: [B.FirFilter(T10), B.FirFilter(LP49[:12], 3, translate=(48_000.0, 5_000.0))],
     _complex(3), 2e-5, 1e-4),
    ("fft_filter_complex_taps", lambda B: [B.FftFilter(T31C)], _complex(4), 1e-5, 3e-3),
    ("fft_float_hilbert_quad_demod",
     lambda B: [B.FftFilterFloat(T21), B.Hilbert(65), B.QuadratureDemod(1.0)],
     _float(5), 1e-5, 1e-3),
    ("fast_fm", lambda B: [B.FastFM()], _complex(6), 1e-6, 1e-5),
    # the resampler behind a drop: di * interp % deci != 0 sets the grid phase
    ("resampler_2_3_after_quad_demod",
     lambda B: [B.QuadratureDemod(1.0), B.RationalResampler(2, 3)], _complex(7), 1e-6, 1e-5),
    ("resampler_3_2_after_fir",
     lambda B: [B.FirFilter(T10), B.RationalResampler(3, 2)], _complex(8), 2e-5, 1e-4),
    ("resampler_5_3_after_fir_deci2",
     lambda B: [B.FirFilter(T17, 2), B.RationalResampler(5, 3)], _float(9), 2e-5, 1e-4),
    ("resampler_1_4", lambda B: [B.RationalResampler(1, 4)], _complex(10), 0.0, 0.0),
    ("slicer_nrzi_descrambler_xor",
     lambda B: [B.BinarySlicer(), B.NrziDecode(), B.Descrambler(0x21, 0, 16),
                B.XorConst(1)], _float(11), 0.0, 0.0),
    ("correlate_access_code",
     lambda B: [B.BinarySlicer(), B.CorrelateAccessCode(CODE1, 1)], _float(12), 0.0, 0.0),
    # a code that begins with zeros matches the zero halo at the stream start
    # in the JAX form; the port's plan zeros those windows, as its offline op
    ("correlate_access_code_leading_zeros",
     lambda B: [B.BinarySlicer(), B.CorrelateAccessCode(CODE0, 2)], _float(13), 0.0, None),
    ("multiply_mag2_add",
     lambda B: [B.MultiplyConst(0.5), B.ComplexToMag2(), B.AddConst(-0.1)],
     _complex(14), 0.0, 1e-6),
    ("complex_to_float", lambda B: [B.ComplexToFloat(), B.MultiplyConst(2.0)],
     _complex(15), 0.0, 1e-6),
    ("tee_complex_to_real", lambda B: [B.Tee(), B.ComplexToReal()], _complex(16), 0.0, 1e-6),
    ("map_elementwise", lambda B: [B.Map(lambda v: v * 2 - 1, elementwise=True)],
     _float(17), 0.0, 1e-6),
]


@pytest.mark.parametrize("name,make,x,tol,jtol", CASES, ids=[c[0] for c in CASES])
def test_torch_shard_chain_equals_offline_and_jax(mesh, name, make, x, tol, jtol):
    got = shard_chain(make(blocks), mesh)(torch.from_numpy(x))
    want = _offline(make(blocks), torch.from_numpy(x))
    m = min(got.shape[0], want.shape[0])
    # the offline chain's length, save trailing samples whose windows pass
    # the stream's end
    assert m >= want.shape[0] - 2 and m > N // 8, (got.shape, want.shape)
    assert got.dtype == want.dtype
    scale = max(1.0, float(want.abs().max()))
    wide = torch.complex128 if got.is_complex() else torch.float64
    err = float((got[:m].to(wide) - want[:m].to(wide)).abs().max())
    assert err <= tol * scale, err
    if jtol is None:
        return
    jmesh = jpar.make_mesh(N_DEV)
    jgot = np.asarray(jshard_chain(make(jblocks), jmesh)(jax.numpy.asarray(x)))
    assert jgot.shape == tuple(got.shape)
    jerr = float(np.abs(got.numpy().astype(np.complex128) - jgot).max())
    assert jerr <= jtol * scale, jerr


def test_torch_shard_chain_list_input_and_numpy(mesh):
    x = _complex(20)
    chain = [blocks.FirFilter(LP49, 4), blocks.QuadratureDemod(1.0)]
    f = shard_chain(chain, mesh)
    whole = f(torch.from_numpy(x))
    assert torch.equal(f(x), whole)  # numpy: host data, sharded onto the mesh
    shards = list(torch.from_numpy(x).split(N // N_DEV))
    assert torch.equal(f(shards), whole)


def _dag(mesh, nodes_spec):
    """A MeshSegment of ``nodes_spec``: (block, [(input node index, port)])
    with -1 the external input; the last node's port 0 the output."""
    nodes = []
    ext = _Node(None, -1)
    for i, (b, ins) in enumerate(nodes_spec):
        n = _Node(b, i)
        n.inputs = [_Port(ext if j < 0 else nodes[j], p) for j, p in ins]
        nodes.append(n)
    return MeshSegment(nodes, [(-1, 0)], [(len(nodes) - 1, 0)], mesh, "time")


@pytest.mark.parametrize("combiner", ["add", "xor", "float_to_complex"])
def test_torch_mesh_segment_runs_the_elementwise_combiners(mesh, combiner):
    if combiner == "add":
        x = torch.from_numpy(_complex(21))
        spec = [(blocks.Tee(), [(-1, 0)]), (blocks.MultiplyConst(3.0), [(0, 1)]),
                (blocks.Add(), [(0, 0), (1, 0)])]
        want = x + 3.0 * x
    elif combiner == "xor":
        x = torch.from_numpy((_float(22) > 0).astype(np.uint8))
        spec = [(blocks.Tee(), [(-1, 0)]), (blocks.XorConst(1), [(0, 1)]),
                (blocks.Xor(), [(0, 0), (1, 0)])]
        want = torch.ones_like(x)
    else:
        x = torch.from_numpy(_complex(23))
        spec = [(blocks.ComplexToFloat(), [(-1, 0)]),
                (blocks.FloatToComplex(), [(0, 0), (0, 1)])]
        want = x
    ms = _dag(mesh, spec)
    _, (got,) = ms.run(ms.init_carries(x), {}, x)
    assert torch.equal(got, want)


def test_torch_mesh_segment_rejects_combiners_whose_inputs_differ(mesh):
    # an input behind a quadrature demod (drop 1) beside the raw stream
    spec = [(blocks.Tee(), [(-1, 0)]), (blocks.QuadratureDemod(1.0), [(0, 1)]),
            (blocks.ComplexToReal(), [(0, 0)]), (blocks.Add(), [(2, 0), (1, 0)])]
    with pytest.raises(NotShardable, match="differ in rate or drop"):
        _dag(mesh, spec)


def test_torch_shard_chain_refuses_what_it_cannot_plan(mesh):
    # a recurrence with no plan, a flush block, a lambda not declared
    # pointwise: NotShardable, never an unsharded run in its place
    with pytest.raises(NotShardable, match="SinglePoleIirFilter has no shard plan"):
        shard_chain([blocks.FirFilter(T17), blocks.SinglePoleIirFilter(0.1)], mesh)
    with pytest.raises(NotShardable, match="Delay not mesh-eligible"):
        shard_chain([blocks.Delay(5)], mesh)
    with pytest.raises(NotShardable, match="has no shard plan"):
        shard_chain([blocks.Map(lambda v: v)], mesh)
    with pytest.raises(NotShardable, match="no shard plan"):
        shard_chain([blocks.CorrelateAccessCodeTag(CODE1)], mesh)
    # the JAX planner refuses the same
    jmesh = jpar.make_mesh(N_DEV)
    from rustradio_tpu.parallel.graph_mesh import NotShardable as JNotShardable

    with pytest.raises(JNotShardable, match="Delay not mesh-eligible"):
        jshard_chain([jblocks.Delay(5)], jmesh)


def test_torch_shard_plans_match_the_jax_plans():
    # halo, start drop and length divisor of every plan, block by block
    cases = [lambda B: B.FirFilter(LP49, 4), lambda B: B.FirFilter(T17),
             lambda B: B.FftFilter(T31C), lambda B: B.FftFilterFloat(T21),
             lambda B: B.Hilbert(65), lambda B: B.RationalResampler(3, 2),
             lambda B: B.QuadratureDemod(1.0), lambda B: B.FastFM(),
             lambda B: B.NrziDecode(), lambda B: B.Descrambler(),
             lambda B: B.CorrelateAccessCode(CODE1), lambda B: B.AddConst(1.0),
             lambda B: B.Add(), lambda B: B.Tee(), lambda B: B.BinarySlicer(),
             lambda B: B.Map(abs, elementwise=True)]
    for make in cases:
        for di in (0, 1, 5):
            p, j = make(blocks).shard_fn(di), make(jblocks).shard_fn(di)
            assert (p.halo, p.d_out, p.div) == (j.halo, j.d_out, j.div), make(blocks)
            b, jb = make(blocks), make(jblocks)
            for n in (0, 1, 100, 1001):
                assert b.shard_total_out(n) == jb.shard_total_out(n)
    for make in (lambda B: B.SinglePoleIirFilter(0.1), lambda B: B.Map(abs)):
        assert make(blocks).shard_fn(0) is None and make(jblocks).shard_fn(0) is None


def test_torch_shard_state_rebuilds_the_streaming_state():
    # FirFilter: the carried buffer of a stream cut after `consumed` samples
    x = torch.from_numpy(_complex(24, 1000))
    fir = blocks.FirFilter(LP49, 4)
    state, _ = fir.apply_chunk(fir.init_state(), x[:333])
    rebuilt = fir.shard_state(x[333 - 48 : 333], 333)
    assert rebuilt["out_off"] == state["out_off"]
    assert torch.equal(rebuilt["buf"], state["buf"])
    _, y1 = fir.apply_chunk(state, x[333:])
    _, y2 = fir.apply_chunk(rebuilt, x[333:])
    assert torch.equal(y1, y2)
    # the resampler's offsets from the consumed count
    rs = blocks.RationalResampler(3, 2)
    st, _ = rs.apply_chunk(rs.init_state(), x[:101])
    assert rs.shard_state(None, 101) == st
    # the tail-state family and the halo-free blocks
    assert torch.equal(blocks.Descrambler().shard_state(x.real[:17] > 0, 50),
                       x.real[:17] > 0)
    assert blocks.AddConst(1.0).shard_state(None, 10) is None
