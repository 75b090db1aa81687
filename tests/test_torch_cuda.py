"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere.  They import only torch, numpy and the port, so they run on a
machine without jax:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rustradio_tpu_torch import blocks, native, ops
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.models import ax25, multichannel
from rustradio_tpu_torch.ops import kernels

# the JAX package's budgets against float64 (tests/test_pallas_interpret.py)
BUDGET = {"highest": 2e-4, "w3": 3e-4, "w2": 8e-3, "split3": 8e-3, "i8": 3e-4}

pytestmark = pytest.mark.cuda

# The FIR core's launcher takes small tiles of 4 outputs a thread for a
# small input, and from WIDE outputs on (two blocks per SM of 1024) its
# widest shape, 8 outputs a thread in tiles of 1024: every edge case runs
# at its own small count and again with WIDE outputs more, where the
# launcher itself takes the shape of every full-size call.
WIDE = 264 * 1024


@pytest.fixture(params=[0, WIDE], ids=["small", "wide"])
def extra(request):
    return request.param


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fm_iq(rng, n, device):
    """A constant-envelope FM signal plus noise on the 8-bit wire grid."""
    phase = np.cumsum(0.9 * np.sin(np.arange(n) * 2e-3))
    noise = 0.02 * rng.randn(2, n)
    planes = [np.round(np.clip((0.45 * f(phase) + e) * 128, -127, 128)) / 128
              for f, e in ((np.cos, noise[0]), (np.sin, noise[1]))]
    return [torch.from_numpy(p.astype(np.float32)).to(device) for p in planes]


def _lp49():
    return np.asarray(np.hamming(49) * np.sinc(0.2 * (np.arange(49) - 24)),
                      np.float32)


def _slow_fm_planes(rng, n, ntaps, deci, device):
    """Wire-grid I/Q planes of an FM signal slow enough to pass an
    ``ntaps`` moving-average-like low-pass at full amplitude, and to turn
    by at most 1 rad per output at ``deci``: no angle comes near +-pi,
    where the last bit of the conjugate product picks the branch."""
    dev = min(0.9, 2.0 / ntaps, 1.0 / deci)
    phase = np.cumsum(dev * np.sin(np.arange(n) * (2e-3 * dev)))
    noise = 0.02 * rng.randn(2, n)
    planes = [np.round(np.clip((0.45 * f(phase) + e) * 128, -127, 128)) / 128
              for f, e in ((np.cos, noise[0]), (np.sin, noise[1]))]
    return [torch.from_numpy(p.astype(np.float32)).to(device) for p in planes]


def _lp(ntaps):
    """A unit-gain Hamming low-pass of ``ntaps`` taps."""
    w = np.hamming(ntaps) if ntaps > 1 else np.ones(1)
    return (w / w.sum()).astype(np.float32)


def _span_case(device, precision, ntaps, deci, first, count, shift, L, seed=17):
    """Kernel B against its plain version on one span of (L,) planes:
    audio at the precision's budget, the last filtered sample at the FIR
    budget."""
    rng = np.random.RandomState(seed)
    a, b = _slow_fm_planes(rng, L, ntaps, deci, device)
    pa, pb = kernels.plane_cast(a, precision), kernels.plane_cast(b, precision)
    kw = dict(first=first, count=count, shift=shift, precision=precision,
              offset=0.01, seed=(0.3, -0.2))
    taps = _lp(ntaps)
    before = kernels.LAUNCHES["fm_chain"]
    got, last = kernels.fm_chain_span(pa, pb, taps, deci, 0.9, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_chain"] == before + 1
    want, want_last = kernels.fm_chain_span_plain(pa, pb, taps, deci, 0.9, **kw)
    assert got.shape == want.shape == (count,)
    assert float((got - want).abs().max()) <= BUDGET[precision]
    assert float((last - want_last).abs().max()) <= 2e-5


@pytest.mark.parametrize("precision,residue", [
    (p, r) for p, v in (("highest", 4), ("w3", 8), ("i8", 16)) for r in range(v)])
def test_torch_cuda_fm_chain_span_every_start_residue(cuda_device, extra,
                                                      precision, residue):
    # the staged span starts at every residue of the planes' 16-byte grid
    _span_case(cuda_device, precision, 49, 4, first=3, count=2500 + extra,
               shift=-48 + residue, L=(1 << 15) + 4 * extra)


@pytest.mark.parametrize("ntaps,deci", [(1, 1), (7, 1), (9, 1), (3, 4), (5, 4),
                                        (49, 4), (49, 3), (1205, 1), (4096, 1),
                                        (4096, 50), (1, 50), (49, 50)])
def test_torch_cuda_fm_chain_span_taps_and_deci(cuda_device, extra, ntaps,
                                                deci):
    count = 1500 + extra
    L = count * deci + ntaps
    for precision in ("w3", "i8"):
        # the span runs past both ends of the plane (pad 0, or -1 for s8)
        _span_case(cuda_device, precision, ntaps, deci, first=0, count=count,
                   shift=1 - ntaps, L=L - 7)


@pytest.mark.parametrize("count", [1, 2, 1023, 1024, 1025, 2047, 2049])
def test_torch_cuda_fm_chain_span_counts_around_a_tile(cuda_device, extra,
                                                       count):
    # wide: the last tile of 1024 holds 1, 2, 1023, all or (2047) its
    # outputs but one
    for precision in ("w3", "i8"):
        _span_case(cuda_device, precision, 49, 4, first=7, count=count + extra,
                   shift=-48, L=(1 << 14) + 4 * extra)


@pytest.mark.parametrize("precision", ["w3", "i8"])
def test_torch_cuda_fm_chain_window_ending_at_the_planes_end(cuda_device,
                                                             extra,
                                                             precision):
    # the last window of a plane whose final sample is the span's last
    first, count, deci, ntaps = 4096, 4096 + extra, 4, 49
    L = (first + count - 1) * deci + ntaps
    _span_case(cuda_device, precision, ntaps, deci, first=first, count=count,
               shift=0, L=L)


def test_torch_cuda_fm_chain_span_null_seed_is_zero_seed(cuda_device):
    rng = np.random.RandomState(49)
    a, b = _fm_iq(rng, 1 << 14, cuda_device)
    pa, pb = kernels.plane_cast(a, "w3"), kernels.plane_cast(b, "w3")
    kw = dict(first=0, count=4000, shift=-48, precision="w3")
    got = kernels.fm_chain_span(pa, pb, _lp49(), 4, **kw)
    zero = kernels.fm_chain_span(pa, pb, _lp49(), 4, seed=(0.0, 0.0), **kw)
    assert torch.equal(got[0], zero[0]) and torch.equal(got[1], zero[1])


@pytest.mark.parametrize("ntaps,deci", [(1, 1), (3, 1), (5, 1), (7, 1), (9, 1),
                                        (49, 4), (49, 3), (1205, 1), (4096, 1),
                                        (4096, 50), (1, 50), (65, 2)])
@pytest.mark.parametrize("n", [1, 1023 * 4, 1025 * 4 + 1, (1 << 16) + 3])
def test_torch_cuda_fir_decimate_edges(cuda_device, extra, ntaps, deci, n):
    n += extra * deci  # WIDE outputs more
    rng = np.random.RandomState(50)
    base = torch.from_numpy(rng.randn(n + 3).astype(np.float32)).to(cuda_device)
    taps = rng.randn(ntaps).astype(np.float32)
    for off in range(4):  # every residue of the 16-byte grid
        x = base[off : off + n]
        got = kernels.fir_decimate(x, taps, deci)
        want = kernels.fir_decimate_plain(x, taps, deci)
        assert got.shape == want.shape == (-(-n // deci),)
        tol = 2e-5 * max(float(want.abs().max()), 1e-3)
        assert float((got - want).abs().max()) <= tol, off


@pytest.mark.parametrize("complex_taps", [False, True])
def test_torch_cuda_fir_decimate_complex_is_one_launch_per_tap_set(
        cuda_device, complex_taps):
    rng = np.random.RandomState(51)
    n = (1 << 15) + 5  # the Q plane starts off the 16-byte grid
    x = torch.from_numpy((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64))
    x = x.to(cuda_device)
    taps = rng.randn(49).astype(np.float32)
    if complex_taps:
        taps = (taps + 1j * rng.randn(49)).astype(np.complex64)
    before = kernels.LAUNCHES["fir_decimate"]
    got = kernels.fir_decimate(x, taps, 4)
    assert kernels.LAUNCHES["fir_decimate"] == before + (2 if complex_taps else 1)
    want = kernels.fir_decimate_plain(x, taps, 4)
    tol = 2e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    if not complex_taps:
        # the 2-plane launch equals two 1-plane launches bit for bit
        re = kernels.fir_decimate(x.real.contiguous(), taps, 4)
        im = kernels.fir_decimate(x.imag.contiguous(), taps, 4)
        assert torch.equal(got, torch.complex(re, im))


def test_torch_cuda_fir_decimate_matches_plain(cuda_device):
    rng = np.random.RandomState(40)
    x = torch.from_numpy(rng.randn(1 << 16).astype(np.float32)).to(cuda_device)
    for ntaps, deci in [(49, 4), (1205, 1), (4096, 7), (3, 300)]:
        taps = rng.randn(ntaps).astype(np.float32)
        before = kernels.LAUNCHES["fir_decimate"]
        got = kernels.fir_decimate(x, taps, deci)
        assert kernels.LAUNCHES["fir_decimate"] == before + 1
        want = kernels.fir_decimate_plain(x, taps, deci)
        # fixed-order f32 FMA against cuDNN's f32 convolution (TF32 off)
        tol = 2e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, (ntaps, deci)


@pytest.mark.parametrize("precision", list(BUDGET))
def test_torch_cuda_fm_chain_span_matches_plain(cuda_device, precision):
    rng = np.random.RandomState(41)
    a, b = _fm_iq(rng, 1 << 16, cuda_device)
    pa, pb = kernels.plane_cast(a, precision), kernels.plane_cast(b, precision)
    kw = dict(first=5, count=3000, shift=-48, precision=precision,
              offset=0.01, seed=(0.3, -0.2))
    got, last = kernels.fm_chain_span(pa, pb, _lp49(), 4, 0.9, **kw)
    want, want_last = kernels.fm_chain_span_plain(pa, pb, _lp49(), 4, 0.9, **kw)
    assert float((got - want).abs().max()) <= BUDGET[precision]
    assert float((last - want_last).abs().max()) <= 1e-5
    # whole flat stream through fm_chain, full-conv grid from 0
    got = kernels.fm_chain(a, b, _lp49(), 4, 0.9, precision=precision)
    want = kernels.fm_chain_span_plain(pa, pb, _lp49(), 4, 0.9, first=0,
                                       count=1 << 14, shift=-48,
                                       precision=precision)[0][1:]
    assert float((got - want).abs().max()) <= BUDGET[precision]


def test_torch_cuda_window_chaining_and_graph_launches(cuda_device):
    rng = np.random.RandomState(42)
    tile_rows, deci = 16, 4
    chunk = deci * 128 * tile_rows
    a, b = _fm_iq(rng, 4 * chunk, cuda_device)
    taps = _lp49()
    pa = kernels.fm_plane_pack(a, taps, deci, tile_rows, "w3")
    pb = kernels.fm_plane_pack(b, taps, deci, tile_rows, "w3")
    a1, last1 = kernels.fm_chain_window(pa, pb, taps, deci, row0=0, g=1,
                                        tile_rows=tile_rows)
    a2, last2 = kernels.fm_chain_window(pa, pb, taps, deci, row0=tile_rows,
                                        g=1, tile_rows=tile_rows, seed=last1)
    both, last12 = kernels.fm_chain_window(pa, pb, taps, deci, row0=0, g=2,
                                           tile_rows=tile_rows)
    # identical per-sample arithmetic: chained == one call, bit for bit
    assert torch.equal(torch.cat([a1, a2]), both)
    assert torch.equal(last2, last12)

    g = Graph()
    src = g.add(blocks.PackedIqRingSource(a, b, taps, deci, tile_rows=tile_rows))
    fir = g.add(blocks.FirFilter(taps, deci=deci, precision="w3"), src)
    q = g.add(blocks.QuadratureDemod(1.0), fir)
    g.add(blocks.DeviceFoldSink(), q)
    fn = g.compile_device_loop(chunk, 6, device=cuda_device, cuda_graph=False)
    before = kernels.LAUNCHES["fm_chain"]
    got = float(next(iter(fn(0).values())))
    assert kernels.LAUNCHES["fm_chain"] == before + 6
    assert np.isfinite(got)


@pytest.mark.parametrize("ring", [True, False])
def test_torch_cuda_device_loop_replay_equals_eager(cuda_device, ring):
    # the captured CUDA graph against the eager loop: bit-equal folds,
    # replayed twice and at a second offset0; a replay counts its launches
    rng = np.random.RandomState(52)
    tile_rows, deci, n_chunks = 16, 4, 6
    chunk = deci * 128 * tile_rows
    a, b = _fm_iq(rng, 4 * chunk, cuda_device)
    taps = _lp49()

    def build(cuda_graph):
        g = Graph()
        if ring:
            src = g.add(blocks.PackedIqRingSource(a, b, taps, deci,
                                                  tile_rows=tile_rows))
        else:
            src = g.add(blocks.VectorSource(torch.complex(a, b).cpu().numpy(),
                                            repeat=3))
        fir = g.add(blocks.FirFilter(taps, deci=deci, precision="w3"), src)
        q = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=lambda c, x: c + x.sum() + (x * x).sum()),
              q)
        return g.compile_device_loop(chunk, n_chunks, device=cuda_device,
                                     cuda_graph=cuda_graph)

    eager, replay = build(False), build(True)
    for offset0 in (0, chunk, 0, 3 * chunk):
        want = next(iter(eager(offset0).values()))
        before = kernels.LAUNCHES["fm_chain"]
        first = next(iter(replay(offset0).values()))
        again = next(iter(replay(offset0).values()))
        assert kernels.LAUNCHES["fm_chain"] >= before + 2 * n_chunks
        assert torch.equal(first, want) and torch.equal(again, want)
        assert bool(torch.isfinite(want))
    before = kernels.LAUNCHES["fm_chain"]
    replay(chunk)  # captured above: a replay alone
    assert kernels.LAUNCHES["fm_chain"] == before + n_chunks
    with pytest.raises(ValueError, match="not a multiple of chunk_size"):
        replay(chunk // 2)


@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 37, 129, 2, 1, 0])
def test_torch_cuda_quad_demod_matches_plain(cuda_device, n):
    rng = np.random.RandomState(43)
    x = torch.from_numpy((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64))
    x = x.to(cuda_device)
    before = kernels.LAUNCHES["quad_demod"]
    got = ops.quad_demod_fast(x, 0.7)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quad_demod"] == before + (n >= 2)
    want = kernels.quad_demod_fast_plain(x, 0.7)
    assert got.shape == want.shape == (max(n - 1, 0),)
    if n >= 2:
        # unfused conjugate product: Re, Im and the +-pi branch as the plain
        # version's; the polynomial's FMA contraction moves a few ulps
        d = (got - want + np.pi * 0.7) % (2 * np.pi * 0.7) - np.pi * 0.7
        assert float(d.abs().max()) <= 1e-6 * 0.7


def test_torch_cuda_ax25_1200_rx_runs_on_kernel_a(cuda_device):
    fs, frames = 24_000.0, [b"CARD FRAME ONE", b"CARD FRAME TWO, LONGER"]
    parts = []
    for p in frames:
        bits = ops.hdlc_frame(ops.fcs_add(np.frombuffer(p, np.uint8)))
        line = ops.nrzi_encode(torch.from_numpy(bits)).numpy()
        at = np.minimum((np.arange(len(line) * 20) / 20).astype(int),
                        len(line) - 1)
        f = np.where(line[at] == 1, 1200.0, 2200.0)
        parts += [np.zeros(400), 0.5 * np.sin(np.cumsum(2 * np.pi * f / fs))]
    audio = np.concatenate(parts + [np.zeros(400)]).astype(np.float32)
    before = kernels.LAUNCHES["fir_decimate"]
    got = [bytes(p) for p in ax25.ax25_1200_rx(audio, fs, device=cuda_device)]
    assert kernels.LAUNCHES["fir_decimate"] > before
    assert got == frames
    assert got == [bytes(p) for p in ax25.ax25_1200_rx(audio, fs, device="cpu")]


def _nrz_bank(seed, c, n, sps, sigma):
    """Noisy NRZ of random bits, as bench.py's decode bank makes it."""
    rng = np.random.RandomState(seed)
    r = int(round(sps))
    bits = rng.randint(0, 2, (c, n // r + 1)) * 2.0 - 1.0
    x = np.repeat(bits, r, axis=1)[:, :n].astype(np.float32)
    return x + rng.randn(c, n).astype(np.float32) * sigma


@pytest.mark.parametrize("taps", [(0.5, 0.5), (1 / 6,) * 6])
def test_torch_cuda_symbol_sync_scan_matches_plain_and_native(cuda_device, taps):
    # kernel E: bit-equal to its plain version (mask, clocks, final state)
    # and its emitted symbols to native rr_symbol_sync, channel by channel
    x = _nrz_bank(44, 8, 4096, 36.75, 0.1)
    x[7] = np.random.RandomState(45).randn(4096)  # chatter on every sample
    xt = torch.from_numpy(x).to(cuda_device)
    before = kernels.LAUNCHES["symbol_sync_scan"]
    (v, m, c), st = ops.symbol_sync(xt, 36.75, 0.5, taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["symbol_sync_scan"] == before + 1
    (_, pm, pc), pst = ops.symbol_sync(torch.from_numpy(x), 36.75, 0.5, taps)
    assert torch.equal(m.cpu(), pm) and torch.equal(c.cpu(), pc)
    for k in st:
        assert torch.equal(st[k].cpu(), pst[k]), k
    for ch in range(8):
        np.testing.assert_array_equal(
            ops.compact(v[ch], m[ch]).cpu().numpy(),
            native.symbol_sync_f32(x[ch], 36.75, 0.5, taps))
    # chunks with the state carried on the card give the whole stream
    (_, m1, _), s1 = ops.symbol_sync(xt[:, :1500], 36.75, 0.5, taps)
    (_, m2, _), s2 = ops.symbol_sync(xt[:, 1500:], 36.75, 0.5, taps, state=s1)
    assert torch.equal(torch.cat([m1, m2], 1), m)


@pytest.mark.parametrize("taps", [(0.5, 0.5), (1 / 6,) * 6])
def test_torch_cuda_symbol_sync_events_matches_plain(cuda_device, taps):
    # kernel D: mask, clocks, valid and the carried state bit-equal to its
    # plain version, whole and in chunks; an overflowing channel is flagged
    x = _nrz_bank(46, 8, 1 << 14, 36.75, 0.1)
    x[7] = np.random.RandomState(47).randn(1 << 14)
    xt = torch.from_numpy(x).to(cuda_device)
    before = kernels.LAUNCHES["symbol_sync_events"]
    (_, m, c), valid, st = ops.symbol_sync_events(
        xt, 36.75, 0.5, taps, max_events=1024, return_state=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["symbol_sync_events"] == before + 1
    (_, pm, pc), pvalid, pst = ops.symbol_sync_events(
        torch.from_numpy(x), 36.75, 0.5, taps, max_events=1024,
        return_state=True)
    assert valid[:7].all() and not valid[7]
    assert torch.equal(valid.cpu(), pvalid)
    # channel 7 overflowed its budget: its outputs are not compared
    assert torch.equal(m[:7].cpu(), pm[:7]) and torch.equal(c[:7].cpu(), pc[:7])
    for k in st["ev"]:
        assert torch.equal(st["ev"][k][:7].cpu(), pst["ev"][k][:7]), k
    (_, m1, _), _, s1 = ops.symbol_sync_events(xt[:7, :6000], 36.75, 0.5, taps,
                                               max_events=512, return_state=True)
    (_, m2, _), v2, _ = ops.symbol_sync_events(xt[:7, 6000:], 36.75, 0.5,
                                               taps, max_events=1024, state=s1)
    assert v2.all() and torch.equal(torch.cat([m1, m2], 1), m[:7])


def test_torch_cuda_symbol_sync_events_scan_padding_tail(cuda_device):
    # kernel D stops at each channel's first padding slot and fills the
    # tail in parallel: every slot's state and the final state bit-equal
    # to the plain version, with tails of different lengths per channel
    x = torch.from_numpy(_nrz_bank(48, 5, 1 << 13, 26.67, 0.1))
    x[1, 3000:] = 1.0  # no crossing after sample 3000
    x[2] = 1.0  # none at all
    n = x.shape[1]
    sign = x > 0
    changed = torch.cat([sign[:, :1], sign[:, 1:] != sign[:, :-1]], 1)
    budget = 1 << 12
    events = torch.full((5, budget), n, dtype=torch.int32)
    for c in range(5):
        pos = torch.nonzero(changed[c]).flatten()[:budget]
        events[c, : len(pos)] = pos.to(torch.int32)
    fstate = torch.tensor([[26.67, 14.335, 1.0, 26.67]] * 5)
    istate = torch.tensor([[-1, 0, 0]] * 5, dtype=torch.int32)
    args = (26.67, 0.5, (0.5, 0.5))
    want = kernels.symbol_sync_events_scan_plain(events, n, *args, fstate, istate)
    got = kernels.symbol_sync_events_scan(
        events.to(cuda_device), n, *args, fstate.to(cuda_device),
        istate.to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("sync", ["scan", "events"])
def test_torch_cuda_decode_band_runs_on_kernels(cuda_device, sync):
    fs, payload = 512_000.0, b"CARD BAND FRAME"
    bits = ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8)))
    line = ops.nrzi_encode(torch.from_numpy(bits)).numpy()
    sps = 32_000.0 / 1200.0
    at = np.minimum((np.arange(int(len(line) * sps)) / sps).astype(int),
                    len(line) - 1)
    a = np.sin(np.cumsum(2 * np.pi * np.where(line[at] == 1, 1200.0, 2200.0)
                         / 32_000.0))
    up = np.repeat(np.concatenate([np.zeros(400), 0.8 * a, np.zeros(400)]), 16)
    t = np.arange(len(up)) / fs
    iq = np.exp(1j * (2 * np.pi * np.cumsum(3000.0 * up) / fs
                      + 2 * np.pi * 5 * fs / 16 * t)).astype(np.complex64)
    key = "symbol_sync_events" if sync == "events" else "symbol_sync_scan"
    before = dict(kernels.LAUNCHES)
    res = multichannel.decode_band_ax25(iq, fs, n_channels=16, max_active=3,
                                        sync_method=sync, device=cuda_device)
    assert kernels.LAUNCHES[key] > before[key]
    assert kernels.LAUNCHES["fir_decimate"] > before["fir_decimate"]
    got = {r.channel: [bytes(p) for p in r.packets] for r in res}
    assert got == {5: [payload]}
    cpu = multichannel.decode_band_ax25(iq, fs, n_channels=16, max_active=3,
                                        sync_method=sync, device="cpu")
    assert {r.channel: [bytes(p) for p in r.packets] for r in cpu} == got
