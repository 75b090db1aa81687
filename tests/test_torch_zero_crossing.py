"""The port's fixed-clock zero-crossing recovery (``ops.zero_crossing_sync``,
``blocks.ZeroCrossing``, ``native.zero_crossing_f32``) against native
``rr_zero_crossing`` and the JAX package's scan.

Native is the arbiter (ROADMAP queue 3, item 1).  Tolerance per case: the
port's symbols and state equal native's bit for bit in every case; the
JAX scan's mask, symbols and state equal the port's bit for bit in every
case below (its arithmetic is additions of f32 values and a halving, which
XLA's CPU backend cannot contract into an FMA that rounds otherwise).
Inputs are seeded numpy arrays; the JAX side runs on the CPU.
"""

import importlib

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu import ops as jops
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu_torch import blocks, native, ops
from rustradio_tpu_torch.convert import state_from_jax
from rustradio_tpu_torch.graph import Graph

# the package's ``ops.symbol_sync`` is the function; this is the module
sync_mod = importlib.import_module("rustradio_tpu_torch.ops.symbol_sync")


def _nrz(sps: float, n: int, noise: float, seed: int) -> np.ndarray:
    """Random +-1 symbols held for ``sps`` samples each (drifting grid),
    plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, int(n / sps) + 2) * 2.0 - 1.0
    idx = np.minimum((np.arange(n) / sps).astype(int), len(bits) - 1)
    return (bits[idx] + noise * rng.randn(n)).astype(np.float32)


CASES = {
    "sps 2.5 clean": _nrz(2.5, 6000, 0.0, 1),
    "sps 8 noisy": _nrz(8.0, 12000, 0.3, 2),
    "sps 20.8333 noisy": _nrz(20.8333, 20000, 0.4, 3),
    "sps 41.6667 clean": _nrz(41.6667, 20000, 0.0, 4),
    "sps 100 noisy": _nrz(100.0, 30000, 0.2, 5),
    "silence": np.zeros(5000, np.float32),
    "chatter": np.random.RandomState(6).randn(8000).astype(np.float32),
    "sine": np.sin(np.arange(10000) * 0.05).astype(np.float32),
}
SPS = {"silence": 10.0, "chatter": 4.0, "sine": 62.8}


def _sps(name: str) -> float:
    return SPS.get(name) or float(name.split()[1])


def _state_equal(a: dict, b: dict) -> bool:
    return (bool(a["last_sign"]) == bool(b["last_sign"])
            and np.float32(a["last_cross"]) == np.float32(b["last_cross"])
            and int(a["counter"]) == int(b["counter"]))


@pytest.mark.parametrize("name", list(CASES))
def test_torch_zero_crossing_op_equals_native_and_jax(name):
    x, sps = CASES[name], _sps(name)
    (vals, mask), state = ops.zero_crossing_sync(torch.from_numpy(x), sps)
    assert vals.dtype == torch.float32 and mask.dtype == torch.bool
    assert torch.equal(vals, torch.from_numpy(x))
    nat, nat_state = native.zero_crossing_f32(x, sps)
    assert np.array_equal(x[mask.numpy()], nat)  # native: bit for bit
    assert _state_equal(state, nat_state)
    (jv, jm), jstate = jops.zero_crossing_sync(x, sps)
    assert np.array_equal(np.asarray(jm), mask.numpy())  # JAX: bit for bit
    assert _state_equal(state, jstate)
    if name == "silence":
        assert len(nat) == int(len(x) // sps)  # the free-running clock


def test_torch_zero_crossing_op_segments_and_numpy(monkeypatch):
    # streams past 2^24 samples go to native in segments (the positions it
    # is fed must stay exact in f32), the state carried: the same mask
    x, sps = CASES["sps 8 noisy"], 8.0
    (_, whole), whole_state = ops.zero_crossing_sync(torch.from_numpy(x), sps)
    monkeypatch.setattr(sync_mod, "_ZC_SEGMENT", 1000)
    (_, mask), state = ops.zero_crossing_sync(x, sps, device="cpu")
    assert torch.equal(mask, whole) and _state_equal(state, whole_state)
    with pytest.raises(ValueError, match="device="):
        ops.zero_crossing_sync(x, sps)
    with pytest.raises(ValueError, match="sps must be > 1"):
        ops.zero_crossing_sync(x, 1.0, device="cpu")
    (v, m), state = ops.zero_crossing_sync(x[:0], sps, device="cpu")
    assert v.shape == m.shape == (0,)
    assert _state_equal(state, {"last_sign": False, "last_cross": 0.0,
                                "counter": 0})


@pytest.mark.parametrize("chunk", [1, 777, 4096])
def test_torch_zero_crossing_block_chunked_equals_one_pass(chunk):
    x, sps = CASES["sps 20.8333 noisy"], 20.8333
    nat, nat_state = native.zero_crossing_f32(x, sps)
    blk = blocks.ZeroCrossing(sps)
    assert np.array_equal(blk.apply(torch.from_numpy(x)).numpy(), nat)
    # the block's chunk form, state carried, against the one pass
    state, parts = blk.init_state(), []
    for lo in range(0, len(x), chunk):
        state, y = blk.apply_chunk(state, torch.from_numpy(x[lo:lo + chunk]))
        parts.append(y.numpy())
    assert np.array_equal(np.concatenate(parts), nat)
    assert _state_equal(state["sync"], nat_state)
    # and through the streaming runner, and the JAX package's block
    g, sink = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.ZeroCrossing(sps), sink)
    g.run_stream(chunk_size=max(chunk, 500), device="cpu")
    assert np.array_equal(sink.data(), nat)
    jg, jsink = JGraph(), jblocks.VectorSink()
    jg.chain(jblocks.VectorSource(x), jblocks.ZeroCrossing(sps), jsink)
    jg.run_stream(chunk_size=max(chunk, 500))
    assert np.array_equal(np.asarray(jsink.data()), nat)


def test_torch_zero_crossing_block_rejects_sps():
    with pytest.raises(ValueError, match="sps must be > 1"):
        blocks.ZeroCrossing(0.5)


def test_torch_zero_crossing_resumes_a_jax_state(tmp_path):
    # the JAX block's state after the first part, carried across by
    # state_from_jax, continues in the port as one pass would
    x, sps = CASES["sps 41.6667 clean"], 41.6667
    cut = 7777
    jstate, _ = jblocks.ZeroCrossing(sps).apply_chunk(
        jblocks.ZeroCrossing(sps).init_state(), x[:cut])
    state = state_from_jax(jstate, device="cpu")
    state, rest = blocks.ZeroCrossing(sps).apply_chunk(state,
                                                       torch.from_numpy(x[cut:]))
    nat, nat_state = native.zero_crossing_f32(x, sps)
    head = native.zero_crossing_f32(x[:cut], sps)[0]
    assert np.array_equal(np.concatenate([head, rest.numpy()]), nat)
    assert _state_equal(state["sync"], nat_state)
    # a checkpoint of a JAX graph holding the block resumes in the port
    ck = str(tmp_path / "zc.pkl")
    jg, jsink = JGraph(), jblocks.VectorSink()
    jg.chain(jblocks.VectorSource(x), jblocks.ZeroCrossing(sps), jsink)
    jg.run_stream(chunk_size=3000, max_chunks=2, checkpoint_path=ck,
                  checkpoint_every=2)
    g, sink = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.ZeroCrossing(sps), sink)
    g.run_stream(chunk_size=3000, resume_from=ck, device="cpu")
    assert np.array_equal(np.concatenate([np.asarray(jsink.data()), sink.data()]),
                          nat)


@pytest.mark.parametrize("unroll", [1, 4])
def test_torch_zero_crossing_takes_jax_unroll(unroll):
    # ops.zero_crossing_sync(..., unroll=) as the JAX op takes it: accepted
    # and ignored (JAX: bit-identical for any unroll), the same mask
    x, sps = CASES["sps 8 noisy"], 8.0
    (_, mask), state = ops.zero_crossing_sync(torch.from_numpy(x), sps,
                                              unroll=unroll)
    (_, jm), jstate = jops.zero_crossing_sync(x, sps, unroll=unroll)
    assert np.array_equal(np.asarray(jm), mask.numpy())
    assert _state_equal(state, jstate)
