"""The AX.25 1200 bd receiver built from blocks (``ax25_1200_rx_graph``) in
the port against the JAX package's, offline and streamed, with both clock
recoveries; and the repairs that came with the streaming runner: the
device loop refuses sources with tags, runs over ring wraps and offsets
past 2^31, and the JAX converters put their tensors on the card unless
asked for the CPU.
"""

import numpy as np
import pytest
import torch

from rustradio_tpu.models.ax25 import ax25_1200_rx_graph as jax_rx_graph
from rustradio_tpu_torch import blocks, convert, ops
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.models import ax25
from rustradio_tpu_torch.streams import Tag
from test_models import make_afsk
from test_torch_graph import TaglessSource

FS = 24_000.0
# tests/test_multichannel.py:343-356
PAYLOADS = [b"EVENTS BLOCK GRAPH ONE", b"EVENTS BLOCK GRAPH TWO"]


@pytest.fixture(scope="module")
def audio():
    return np.concatenate([make_afsk(p, fs=FS) for p in PAYLOADS])


@pytest.mark.parametrize("streamed", [False, True], ids=["offline", "streamed"])
def test_torch_ax25_graph_native_matches_jax(audio, streamed):
    kw = {"chunk_size": len(audio) // 3} if streamed else {}
    want = jax_rx_graph(audio, FS, **kw)
    got = ax25.ax25_1200_rx_graph(audio, FS, device="cpu", **kw)
    assert got == want == PAYLOADS


@pytest.mark.slow
@pytest.mark.parametrize("streamed", [False, True], ids=["offline", "streamed"])
def test_torch_ax25_graph_events_matches_jax(audio, streamed):
    # the JAX package's event form compiles for a few seconds per shape
    kw = {"chunk_size": len(audio) // 3} if streamed else {}
    want = jax_rx_graph(audio, FS, sync="events", **kw)
    got = ax25.ax25_1200_rx_graph(audio, FS, sync="events", device="cpu", **kw)
    assert got == want == PAYLOADS


@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_ax25_graph_equals_the_receiver(audio, sync):
    # offline, streamed in thirds and in small chunks (frames, symbols and
    # HDLC state across every boundary): the same list as ax25_1200_rx
    want = [bytes(p) for p in ax25.ax25_1200_rx(audio, FS, sync=sync,
                                                device="cpu")]
    assert want == PAYLOADS
    x = torch.from_numpy(audio)  # a tensor runs on its own device
    for chunk in (None, len(audio) // 3, 4096):
        assert ax25.ax25_1200_rx_graph(x, FS, chunk_size=chunk,
                                       sync=sync) == want


def test_torch_ax25_graph_rejects_unknown_sync_and_bare_numpy(audio):
    # the JAX package falls back to "native" without a word
    # (rustradio_tpu/models/ax25.py:247); the port refuses
    with pytest.raises(ValueError, match="unknown sync"):
        ax25.ax25_1200_rx_graph(audio, FS, sync="scan", device="cpu")
    with pytest.raises(ValueError, match="device="):
        ax25.ax25_1200_rx_graph(audio, FS)
    assert ax25.ax25_1200_rx_graph(audio, FS, band=None, device="cpu") == PAYLOADS


# ---- repairs: the device loop and tags, wraps and far offsets

def _fm_loop_graph(src, taps, fold=None):
    g = Graph()
    s = g.add(src)
    fir = g.add(blocks.FirFilter(taps, deci=4), s)
    g.add(blocks.DeviceFoldSink(fn=fold), g.add(blocks.QuadratureDemod(1.0), fir))
    return g


def test_torch_device_loop_refuses_sources_with_tags():
    data = np.zeros(4096, np.complex64)
    taps = np.ones(5, np.float32)
    with pytest.raises(ValueError, match="VectorSource::start"):
        _fm_loop_graph(blocks.VectorSource(data), taps).compile_device_loop(
            1024, 2, device="cpu")
    # a user tag past the first chunk is found as well
    late = TaglessSource(data, tags=[Tag(3000, "user", 1)])
    with pytest.raises(ValueError, match="user"):
        _fm_loop_graph(late, taps).compile_device_loop(1024, 2, device="cpu")
    fn = _fm_loop_graph(TaglessSource(data), taps).compile_device_loop(1024, 2, device="cpu")
    assert float(next(iter(fn(0).values()))) == 0.0
    # run_stream carries the same source's tags
    g, s = Graph(), blocks.VectorSink()
    g.chain(blocks.VectorSource(data[:100], tags=[Tag(30, "user", 1)]),
            blocks.AddConst(1.0), s)
    g.run_stream(chunk_size=40, device="cpu")
    assert [(t.pos, t.key) for t in s.tags() if t.key == "user"] == [(30, "user")]


@pytest.mark.parametrize("offset0", [(1 << 31) - 8192, (1 << 31) + 8192, 0],
                         ids=["below-2^31", "above-2^31", "zero"])
def test_torch_device_loop_wraps_the_ring_far_along(offset0):
    # five chunks over a two-chunk ring, so the loop wraps at every other
    # chunk, from offset0 one chunk under or over 2^31
    rng = np.random.RandomState(90)
    taps = (rng.randn(49) / 7).astype(np.float32)
    deci, tile_rows = 4, 16
    chunk = deci * 128 * tile_rows  # 8192
    ring = 2 * chunk
    re, im = (np.round(np.clip(rng.randn(2, ring) * 38, -128, 127)) / 128
              ).astype(np.float32)
    src = blocks.PackedIqRingSource(re, im, taps, deci, precision="w3",
                                    tile_rows=tile_rows)
    keep = lambda c, y: torch.cat([c.reshape(-1), y])  # noqa: E731
    g = Graph()
    s = g.add(src)
    fir = g.add(blocks.FirFilter(taps, deci=deci, precision="w3"), s)
    g.add(blocks.DeviceFoldSink(fn=keep), g.add(blocks.QuadratureDemod(1.0), fir))
    n_chunks = 5
    loop = g.compile_device_loop(chunk, n_chunks, device="cpu")
    got = next(iter(loop(offset0).values()))[1:]
    # the same loop at the offset reduced by the ring: the same stream
    near = next(iter(loop(offset0 % ring).values()))[1:]
    assert torch.equal(got, near)

    # The offline run of the same samples, as the ring holds them: each
    # chunk is filtered from the ring's own samples, and the window at the
    # ring's start reads zero-history rows, not the ring's last samples
    # (the packed ring's seam, as in rustradio_tpu/blocks/sources.py:234);
    # the discriminator runs across every seam on the carried sample, and
    # the stream's first (ntaps-1)/deci + 1 outputs are dropped as the
    # lowering drops its start-up ramp.
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    per_ring = ops.fir_filter_full(x, taps, deci).numpy().astype(np.complex128)
    rows = chunk // deci
    visited = [(offset0 // chunk + i) % (ring // chunk) for i in range(n_chunks)]
    y = np.concatenate([per_ring[j * rows : (j + 1) * rows] for j in visited])
    want = np.angle(np.conj(y[:-1]) * y[1:])[(len(taps) - 1) // deci :]
    assert got.shape == want.shape
    # kernel B's w3 budget against float64 (tests/test_pallas_interpret.py)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=0)


# ---- repairs: the converters default to the card

def test_torch_converters_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plane = np.zeros((2, 512), np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.packed_from_jax(plane, "highest")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.state_from_jax({"buf": np.zeros(3, np.float32)})
    assert convert.packed_from_jax(plane, "highest", device="cpu").shape == (1024,)
    # host-side leaves stay Python objects; arrays become tensors; integer
    # scalars become ints
    snap = {"state": "synced", "shift": 0x7E, "ones": 2, "cur": [1, 0, 1],
            "stream_pos": 1234, "stats": {"decoded": 1, "crc_error": 0,
                                          "bitfixed": 0}}
    st = convert.state_from_jax(
        {3: snap, 4: np.uint8(1), 5: {"sync": {"clock": np.float32(20.0),
                                               "last_sign": True,
                                               "fbuf": np.ones(5, np.float32)}},
         6: None, 7: (np.zeros(2, np.complex64), 7.5)}, device="cpu")
    assert st[3] == snap and isinstance(st[3]["cur"], list)
    assert st[4] == 1 and isinstance(st[4], int)
    assert torch.is_tensor(st[5]["sync"]["clock"]) and st[5]["sync"]["last_sign"] is True
    assert st[5]["sync"]["fbuf"].shape == (5,)
    assert st[6] is None and st[7][1] == 7.5 and st[7][0].dtype == torch.complex64
