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


class TaglessSource(blocks.VectorSource):
    """The port's VectorSource without its start/repeat/first tags, for the
    device loop, which refuses a source that emits tags."""

    def emit_tags(self, offset, n):
        return [t for t in super().emit_tags(offset, n)
                if not t.key.startswith("VectorSource::")]

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


# f32 values at the edges of plane_cast's rounding: bf16 ties (low half
# 0x8000) on an even and on an odd last bit, subnormals (one a tie), values
# that to_s8 rounds half to even or clamps; and, kept to the planes' ends
# so that they spoil only the outputs there, values that round to bf16
# +-inf, +-inf itself and values that overflow the discriminator.  NaN is
# left out: to_s8 gives no defined value for it.
EDGE_BITS = (0x3F808000, 0x3F818000, 0xBE808000, 0xBE818000, 0x00000001,
             0x00008000, 0x00018000, 0x807FFFFF)
EDGE_VALUES = (2.0, -3.0, 0.5 / 128, 1.5 / 128, -2.5 / 128, 127.5 / 128,
               -127.5 / 128, 128.5 / 128)
END_BITS = (0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7F8000, 0x7149F2CA,
            0xF149F2CA)  # +-inf, two that round to +-inf, +-1e30


def rounding_edges(rng, n, ntaps, deci):
    """An f32 plane of n values off the 8-bit wire grid (``_slow_fm_planes``'
    signal with continuous noise, so that every precision's rounding moves
    nearly every value), the edge values at random places, and the end
    values among the first and the last six (read by the guarded scalar
    loads where the plane starts or ends off the 16-byte grid)."""
    dev = min(0.9, 2.0 / ntaps, 1.0 / deci)
    phase = np.cumsum(dev * np.sin(np.arange(n) * (2e-3 * dev)))
    x = (0.45 * np.cos(phase + rng.uniform(0, 6)) + 0.02 * rng.randn(n)
         ).astype(np.float32)
    edges = np.concatenate([np.array(EDGE_BITS, np.uint32).view(np.float32),
                            np.array(EDGE_VALUES, np.float32)])
    x[rng.choice(np.arange(6, n - 6), 2 * len(edges), replace=False)] = (
        np.tile(edges, 2))
    ends = np.array(END_BITS, np.uint32).view(np.float32)
    x[:6], x[-6:] = rng.permutation(ends), rng.permutation(ends)
    return x


def _same_bits(got, want):
    """Bit-equal f32 tensors (NaN included)."""
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("precision", ["w2", "w3", "i8"])
@pytest.mark.parametrize("ntaps,deci", [(49, 1), (49, 2), (49, 4), (49, 3),
                                        (1205, 1), (1205, 4)])
def test_torch_cuda_fm_chain_rounds_f32_planes_as_the_cast(
        cuda_device, extra, precision, ntaps, deci):
    # f32 planes, which kernel B rounds as it loads them, against the same
    # launch on plane_cast's planes: the same bits, at every start of the
    # plane on its 16-byte grid and lengths that are no multiple of 4
    rng = np.random.RandomState(53 + ntaps + deci)
    n = 4 * 1027 + 1 + extra * deci
    taps = _lp(ntaps)
    base = [torch.from_numpy(rounding_edges(rng, n + 3, ntaps, deci)).to(
        cuda_device) for _ in range(2)]
    for k in range(4):  # the planes start k floats past a 16-byte boundary
        a, b = (p[k : k + n - 2 * (k % 2)] for p in base)
        ca, cb = (kernels.plane_cast(p, precision) for p in (a, b))
        m = -(-a.shape[0] // deci)
        kw = dict(first=0, count=m, shift=1 - ntaps, precision=precision,
                  offset=0.01)
        before = kernels.LAUNCHES["fm_chain"]
        got, last = kernels.fm_chain_span(a, b, taps, deci, 0.9, **kw)
        flat = kernels.fm_chain(a, b, taps, deci, 0.9, offset=0.01,
                                precision=precision)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fm_chain"] == before + 2
        want, want_last = kernels.fm_chain_span(ca, cb, taps, deci, 0.9, **kw)
        _same_bits(got, want)
        _same_bits(last, want_last)
        _same_bits(flat, want[1:])
        assert int(torch.isfinite(want).sum()) > m // 2  # the ends alone spoilt


@pytest.mark.parametrize("precision", ["w2", "w3", "i8"])
def test_torch_cuda_fm_chain_rounded_spans_compose_with_the_seed(
        cuda_device, extra, precision):
    # two seeded spans of f32 planes, the second from first > 0 with the
    # first's last sample, make the one span of the cast planes
    rng = np.random.RandomState(54)
    n = (1 << 14) + 3 + 4 * extra
    a, b = (torch.from_numpy(rounding_edges(rng, n, 49, 4)).to(cuda_device)
            for _ in range(2))
    ca, cb = (kernels.plane_cast(p, precision) for p in (a, b))
    c1, c2 = 1500 + extra // 2, 2100 + extra // 2
    kw = dict(shift=-48, precision=precision, offset=0.01)
    y1, last1 = kernels.fm_chain_span(a, b, _lp49(), 4, 0.9, first=0,
                                      count=c1, seed=(0.3, -0.2), **kw)
    y2, last2 = kernels.fm_chain_span(a, b, _lp49(), 4, 0.9, first=c1,
                                      count=c2, seed=last1, **kw)
    want, want_last = kernels.fm_chain_span(ca, cb, _lp49(), 4, 0.9, first=0,
                                            count=c1 + c2, seed=(0.3, -0.2),
                                            **kw)
    _same_bits(torch.cat([y1, y2]), want)
    _same_bits(last2, want_last)
    cast2 = kernels.fm_chain_span(ca, cb, _lp49(), 4, 0.9, first=c1, count=c2,
                                  seed=last1, **kw)
    _same_bits(y2, cast2[0])


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
            src = g.add(TaglessSource(torch.complex(a, b).cpu().numpy(),
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


# ---- kernels D and E where their tiled, block-per-channel design can
# break: the edge inputs of rustradio_tpu_torch/tools/sync_cases.py (sizes
# around one tile and the two in flight, misaligned rows, silence, chatter,
# crossings on a tile's first and last sample, sps 2.5 to 100, 1 to 16
# taps, cut streams), the kernels on the card against the plain versions on
# the CPU, every output bit for bit

from rustradio_tpu_torch.tools import sync_cases  # noqa: E402

SYNC_CASES = {c.name: c for c in sync_cases.cases()}


@pytest.mark.parametrize("name", list(SYNC_CASES))
def test_torch_cuda_symbol_sync_edge_case(cuda_device, name):
    case = SYNC_CASES[name]
    before = dict(kernels.LAUNCHES)
    got = sync_cases.run_case(case, cuda_device)
    c, n = case.x.shape
    chunks = len(case.cuts) + 1
    # whole + one call per chunk; kernel D also once on its own slots.  An
    # empty stream launches nothing in the per-sample form
    want_e = (1 + chunks) if c and n else 0
    assert kernels.LAUNCHES["symbol_sync_scan"] - before["symbol_sync_scan"] == want_e
    assert (kernels.LAUNCHES["symbol_sync_events"]
            - before["symbol_sync_events"]) == 1 + chunks + 1
    want = sync_cases.run_case(case, "cpu")
    assert sync_cases.mismatches(got, want) == []
    assert sync_cases.self_mismatches(got) == []


@pytest.mark.parametrize("name", list(SYNC_CASES))
def test_torch_cuda_symbol_sync_scan_counts(cuda_device, name):
    # kernel E's counter of its last launch, kernels.SCAN_COUNTS: a row a
    # channel, its crossings walked equal to the input's sign changes (the
    # first sample's against the entry state's last sign), and no more
    # samples stepped one by one than the channel has; an empty stream
    # launches nothing and leaves the counter as it was
    case = SYNC_CASES[name]
    x = torch.from_numpy(case.x).to(cuda_device)
    c, n = x.shape
    before = kernels.SCAN_COUNTS
    ops.symbol_sync(x, case.sps, case.max_deviation, case.taps,
                    state=case.state0)
    counts = kernels.SCAN_COUNTS
    if not (c and n):  # nothing launched, nothing counted
        assert counts is before
        return
    assert counts.device == x.device and counts.dtype == torch.int32
    assert tuple(counts.shape) == (c, 2)
    last = (torch.zeros(c, dtype=torch.bool) if case.state0 is None
            else torch.from_numpy(np.asarray(case.state0["last_sign"], bool)))
    sign = torch.from_numpy(case.x) > 0
    changes = ((sign[:, 0] != last).int()
               + (sign[:, 1:] != sign[:, :-1]).sum(1, dtype=torch.int32))
    got = counts.cpu()
    assert torch.equal(got[:, 0], changes.int())
    assert ((got[:, 1] >= 0) & (got[:, 1] <= n)).all()


def test_torch_cuda_symbol_sync_more_channels_than_sms(cuda_device):
    # 300 channels are 300 blocks on 132 SMs: every channel against the
    # plain version (the per-sample form on a prefix: its plain loop is slow)
    x = _nrz_bank(50, 300, 3000, 12.6, 0.2)
    xt = torch.from_numpy(x).to(cuda_device)
    (_, m, c), valid = ops.symbol_sync_events(xt, 12.6)
    (_, pm, pc), pvalid = ops.symbol_sync_events(torch.from_numpy(x), 12.6)
    assert valid.all() and torch.equal(valid.cpu(), pvalid)
    assert torch.equal(m.cpu(), pm) and torch.equal(c.cpu(), pc)
    (v, m, c), st = ops.symbol_sync(xt, 12.6)
    (_, pm, pc), pst = ops.symbol_sync(torch.from_numpy(x[:, :1100]), 12.6)
    assert torch.equal(m[:, :1100].cpu(), pm)
    assert torch.equal(c[:, :1100].cpu(), pc)
    for ch in range(0, 300, 7):
        np.testing.assert_array_equal(
            ops.compact(v[ch], m[ch]).cpu().numpy(),
            native.symbol_sync_f32(x[ch], 12.6, 0.5, (0.5, 0.5)))


def test_torch_cuda_symbol_sync_events_scan_counts(cuda_device):
    # kernel D told each channel's crossing slots (as ops.symbol_sync_events
    # tells it) and left to find the padding itself: channels that fill
    # their slots, half of them, a handful, and none
    case = SYNC_CASES["slots2049"]
    x = torch.from_numpy(case.x).to(cuda_device)
    x = torch.cat([x, -torch.ones_like(x[:1])])
    for slots in (1023, 1024, 2049):
        args = sync_cases.fresh_event_args(x, case, slots)
        counts = (args[0] < args[1]).sum(1, dtype=torch.int32)
        assert counts[0] >= min(slots, 2000) and counts[3] == 0
        want = kernels.symbol_sync_events_scan_plain(*(a.cpu() if torch.is_tensor(a)
                                                      else a for a in args))
        for got in (kernels.symbol_sync_events_scan(*args, counts),
                    kernels.symbol_sync_events_scan(*args)):
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["slots2049", "chatter_sps2.5"])
def test_torch_cuda_symbol_sync_events_counts(cuda_device, name):
    # kernel D's counter of its last launch, kernels.EVENTS_COUNTS: a row a
    # channel, its slots walked equal to the channel's real slots and its
    # share redone on the general path in [0, 1].  ops.symbol_sync_events
    # from a state on the card reads nothing back to the host (a
    # synchronising call raises in the "error" sync debug mode), so the
    # counter costs a pass no wait
    case = SYNC_CASES[name]
    x = torch.from_numpy(case.x).to(cuda_device)
    c, n = x.shape
    budget = case.max_events or n // 4
    args = (case.sps, case.max_deviation, case.taps)
    _, _, state = ops.symbol_sync_events(x[:, :1], *args, max_events=8,
                                         return_state=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.symbol_sync_events(x[:, 1:], *args, max_events=budget, state=state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kernels.EVENTS_COUNTS
    assert counts.device == x.device and counts.dtype == torch.int32
    assert tuple(counts.shape) == (c, 2)
    sign = torch.from_numpy(case.x) > 0
    changes = (sign[:, 1:] != sign[:, :-1]).sum(1, dtype=torch.int32)
    got = counts.cpu()
    assert torch.equal(got[:, 0], changes.clamp(max=budget))
    share = got[:, 1].double() / got[:, 0].clamp(min=1).double()
    assert ((share >= 0) & (share <= 1)).all()
    # from the kernel's own arguments, with the real slots given and not
    args = sync_cases.fresh_event_args(x, case, budget)
    real = (args[0] < args[1]).sum(1, dtype=torch.int32)
    kernels.symbol_sync_events_scan(*args, real)
    got = kernels.EVENTS_COUNTS.cpu()
    assert torch.equal(got[:, 0], real.cpu()) and (got[:, 1] <= got[:, 0]).all()
    kernels.symbol_sync_events_scan(*args)
    assert torch.equal(kernels.EVENTS_COUNTS.cpu(), got)


def test_torch_cuda_graph_run_defaults_to_the_card(cuda_device):
    rng = np.random.RandomState(62)
    taps = rng.randn(33).astype(np.float32) / 5
    data = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    sinks = []
    for kw in ({}, {"device": "cpu"}):
        g, s = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(data), blocks.FirFilter(taps, deci=2), s)
        before = kernels.LAUNCHES["fir_decimate"]
        g.run(**kw)
        assert (kernels.LAUNCHES["fir_decimate"] > before) == (not kw)
        sinks.append(s.data())
    np.testing.assert_allclose(sinks[0], sinks[1],
                               atol=2e-5 * np.abs(sinks[1]).max(), rtol=0)


def _sweep_audio(n, seed, fs=24_000.0):
    rng = np.random.RandomState(seed)
    f = 1500.0 + 500.0 * np.sin(np.arange(n) * 2e-3)
    return (np.sin(2 * np.pi * np.cumsum(f) / fs) + 0.05 * rng.randn(n)
            ).astype(np.float32)


@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_cuda_run_stream_on_the_card_equals_the_cpu(cuda_device, tmp_path,
                                                         sync):
    # the AX.25 chain from blocks, streamed on the card (kernel A in the
    # front-end, kernel D for events) against the same stream on the CPU;
    # a checkpoint taken on the card resumes on the card
    fs = 24_000.0
    frames = [b"STREAMED ON THE CARD ONE", b"STREAMED ON THE CARD TWO"]
    parts = []
    for p in frames:
        bits = ops.hdlc_frame(ops.fcs_add(np.frombuffer(p, np.uint8)))
        line = ops.nrzi_encode(torch.from_numpy(bits)).numpy()
        at = np.minimum((np.arange(len(line) * 20) / 20).astype(int),
                        len(line) - 1)
        f = np.where(line[at] == 1, 1200.0, 2200.0)
        parts += [np.zeros(400), 0.5 * np.sin(np.cumsum(2 * np.pi * f / fs))]
    audio = np.concatenate(parts + [np.zeros(400)]).astype(np.float32)
    chunk = len(audio) // 4 + 1
    want = ax25.ax25_1200_rx_graph(audio, fs, chunk_size=chunk, sync=sync,
                                   device="cpu")
    before = dict(kernels.LAUNCHES)
    got = ax25.ax25_1200_rx_graph(audio, fs, chunk_size=chunk, sync=sync,
                                  device=cuda_device)
    assert got == want == frames
    assert kernels.LAUNCHES["fir_decimate"] > before["fir_decimate"]
    if sync == "events":
        assert kernels.LAUNCHES["symbol_sync_events"] > before["symbol_sync_events"]
    # the dense front-end streamed on the card against the CPU stream
    from rustradio_tpu_torch import taps as tapgen

    x = _sweep_audio(40_000, 7)
    outs = []
    for dev in (cuda_device, "cpu"):
        g, s = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(x),
                blocks.FftFilterFloat(tapgen.band_pass(fs, 400.0, 2700.0, 65)),
                blocks.Hilbert(65), blocks.QuadratureDemod(1.0),
                blocks.FftFilterFloat(tapgen.low_pass(fs, 1100.0, 200.0)),
                blocks.AddConst(-0.4), s)
        ck = str(tmp_path / f"{torch.device(dev).type}.pkl")
        g.run_stream(chunk_size=9000, max_chunks=2, checkpoint_path=ck,
                     checkpoint_every=2, device=dev)
        g2, s2 = Graph(), blocks.VectorSink()
        g2.chain(*[n.block for n in g.nodes[:-1]], s2)
        g2.run_stream(chunk_size=9000, resume_from=ck, device=dev)
        outs.append(np.concatenate([s.data(), s2.data()]))
    # kernel A against conv1d at 2e-5 of |y| per FIR, through the exact
    # discriminator on a strong signal
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("deci", [1, 3])
def test_torch_cuda_translating_fir_passes_match_plain(cuda_device, deci):
    # fir_filter_translating's complex-tap passes (two kernel-A launches of
    # the I/Q rows) against their plain versions on the same card input
    from rustradio_tpu_torch import taps as tapgen

    rng = np.random.RandomState(33)
    n, fs, freq = (1 << 18) + 7, 1_024_000.0, 123_456.0
    x = torch.complex(torch.from_numpy(rng.randn(n).astype(np.float32)),
                      torch.from_numpy(rng.randn(n).astype(np.float32))
                      ).to(cuda_device)
    taps = tapgen.low_pass_complex(fs, 20_000.0, 10_000.0)
    before = kernels.LAUNCHES["fir_decimate"]
    got = ops.fir_filter_translating(x, taps, fs, freq, deci)
    assert kernels.LAUNCHES["fir_decimate"] == before + 2
    import unittest.mock as mock

    with mock.patch.object(kernels, "fir_decimate", kernels.fir_decimate_plain):
        want = ops.fir_filter_translating(x, taps, fs, freq, deci)
    d = torch.view_as_real(got - want).abs().max()
    assert float(d) <= 2e-5 * float(want.abs().max())


def test_torch_cuda_device_loop_replays_far_offsets(cuda_device):
    # the captured loop at offsets one chunk under and over 2^31, wrapping a
    # two-chunk ring, bit-equal to the eager loop
    rng = np.random.RandomState(53)
    tile_rows, deci, n_chunks = 16, 4, 5
    chunk = deci * 128 * tile_rows
    a, b = _fm_iq(rng, 2 * chunk, cuda_device)
    taps = _lp49()

    def build(cuda_graph):
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(a, b, taps, deci,
                                              tile_rows=tile_rows))
        fir = g.add(blocks.FirFilter(taps, deci=deci, precision="w3"), src)
        q = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=lambda c, x: c + x.sum() + (x * x).sum()),
              q)
        return g.compile_device_loop(chunk, n_chunks, device=cuda_device,
                                     cuda_graph=cuda_graph)

    eager, replay = build(False), build(True)
    near = next(iter(eager(chunk).values()))
    for offset0 in ((1 << 31) - chunk, (1 << 31) + chunk):
        want = next(iter(eager(offset0).values()))
        got = next(iter(replay(offset0).values()))
        assert torch.equal(got, want) and torch.equal(want, near)


# ---- the G3RUH modem and the burst receivers (whole-packet clock recovery)

def _hold_calls(monkeypatch, names):
    """Record the arguments of the wrappers ``kernels.<name>`` (the calls
    still launch)."""
    calls = {n: [] for n in names}
    for n in names:
        real = getattr(kernels, n)
        monkeypatch.setattr(kernels, n, lambda *a, real=real, got=calls[n]:
                            got.append(a) or real(*a))
    return calls


def _held_fir(calls):
    """Kernel A on each recorded call against its plain version, within
    2e-5 of the call's max|y| (the recorded list grows as this runs)."""
    assert calls
    for args in list(calls):
        got = kernels.fir_decimate(*args)
        want = kernels.fir_decimate_plain(*args)
        g, w = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
        assert float((g - w).abs().max()) <= 2e-5 * float(w.abs().max())


@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_cuda_g3ruh_modulate_and_9600_rx(cuda_device, monkeypatch, sync):
    payloads = [b"G3RUH ON THE CARD ONE", b"G3RUH ON THE CARD, TWO"]
    frames = [np.frombuffer(p, np.uint8) for p in payloads]
    calls = _hold_calls(monkeypatch, ["fir_decimate", "symbol_sync_events_scan"])
    iq = ax25.g3ruh_modulate(frames, 300_000.0, device=cuda_device)
    assert iq.device.type == "cuda" and iq.dtype == torch.complex64
    # the 723-tap channel filter on both planes: one kernel-A launch
    assert len(calls["fir_decimate"]) == 1
    _held_fir(calls["fir_decimate"])
    cpu = ax25.g3ruh_modulate(frames, 300_000.0, device="cpu")
    # the VCO's float64 phase sum is a parallel scan on the card, then sin
    # and cos in f32: within 1e-4 of the CPU's
    np.testing.assert_allclose(iq.cpu().numpy(), cpu.numpy(), atol=1e-4, rtol=0)
    lead = torch.zeros(5000, dtype=torch.complex64, device=cuda_device)
    iq = torch.cat([lead, iq, lead])
    # one clock tap, the g3ruh modem's default (examples/g3ruh.rs:77-83):
    # the ax25-9600-rx defaults (0.0001, 0.99999999) hardly move the clock
    # and lose frames of a continuous stream in both packages
    pkts = ax25.ax25_9600_rx(iq, 300_000.0, symbol_taps=(1.0,), sync=sync)
    assert [bytes(p) for p in pkts] == payloads
    if sync == "events":
        assert calls["symbol_sync_events_scan"]
        for args in list(calls["symbol_sync_events_scan"]):
            for g, w in zip(kernels.symbol_sync_events_scan(*args),
                            kernels.symbol_sync_events_scan_plain(*args)):
                assert torch.equal(g, w)


def _afsk_bursts_50k(payloads):
    fs = 50_000.0
    parts = [np.zeros(4000, np.complex64)]
    for p in payloads:
        bits = ops.hdlc_frame(ops.fcs_add(np.frombuffer(p, np.uint8)))
        line = ops.nrzi_encode(torch.from_numpy(bits)).numpy()
        sps = fs / 1200.0
        at = np.minimum((np.arange(int(len(line) * sps)) / sps).astype(int),
                        len(line) - 1)
        audio = 0.5 * np.sin(np.cumsum(2 * np.pi * np.where(
            line[at] == 1, 1200.0, 2200.0) / fs))
        iq, _ = ops.vco(torch.from_numpy((audio * 0.3).astype(np.float32)),
                        k=2 * np.pi * 3500.0 / fs)
        parts += [np.conj(iq.numpy()), np.zeros(4000, np.complex64)]
    return np.concatenate(parts)


def test_torch_cuda_burst_receivers_on_the_card(cuda_device, monkeypatch):
    payloads = [b"AFSK BURST ON THE CARD", b"SECOND AFSK BURST"]
    iq = torch.from_numpy(_afsk_bursts_50k(payloads)).to(cuda_device)
    calls = _hold_calls(monkeypatch, ["fir_decimate"])
    pkts = ax25.ax25_1200_wpcr_rx(iq, 50_000.0, threshold=0.01)
    assert [bytes(p) for p in pkts] == payloads
    # the 1205-tap channel filter, the Hilbert and the 1205-tap low-pass
    assert len(calls["fir_decimate"]) == 3
    _held_fir(calls["fir_decimate"])
    assert [bytes(p) for p in ax25.ax25_1200_wpcr_rx(
        iq.cpu(), 50_000.0, threshold=0.01)] == payloads
    g3 = [b"G3RUH BURST ONE", b"G3RUH BURST TWO"]
    parts = [torch.zeros(20_000, dtype=torch.complex64, device=cuda_device)]
    for p in g3:
        parts += [ax25.g3ruh_modulate([np.frombuffer(p, np.uint8)], 50_000.0,
                                      device=cuda_device), parts[0]]
    pkts = ax25.ax25_9600_wpcr_rx(torch.cat(parts), 50_000.0)
    assert [bytes(p) for p in pkts] == g3


def test_torch_cuda_wpcr_batch_equals_the_cpu(cuda_device):
    # bursts of many lengths (two buckets past the JAX package's chirp
    # bound among them): the same found, bin, phase and symbols on the card
    # as on the CPU, the symbols left on the card
    rng = np.random.RandomState(9)
    bursts = []
    for i in range(40):
        sps = [4, 5, 8, 10][i % 4]
        bits = rng.randint(0, 2, rng.randint(20, 400 if i < 38 else 4000))
        x = np.repeat(bits * 2.0 - 1.0, sps).astype(np.float32)
        bursts.append(x + rng.randn(len(x)).astype(np.float32) * 0.2)
    got = ops.wpcr_batch(bursts, device=cuda_device)
    want = ops.wpcr_batch(bursts, device="cpu")
    assert sum(i["found"] for _, i in want) >= 30
    for (s, i), (ws, wi) in zip(got, want):
        assert s.device.type == "cuda"
        assert i == wi
        assert torch.equal(s.cpu(), ws)
    for (c, ok), (wc, wok) in zip(ops.midpoint_batch(bursts, device=cuda_device),
                                  ops.midpoint_batch(bursts, device="cpu")):
        assert ok == wok and torch.equal(c.cpu(), wc)


def test_torch_cuda_scramble_and_streaming_blocks(cuda_device):
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randint(0, 2, 5 * 512 + 7).astype(np.uint8))
    got, gs = ops.scramble(x.to(cuda_device))
    want, ws = ops.scramble(x)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want) and torch.equal(gs.cpu(), ws)
    assert torch.equal(ops.descramble(x.to(cuda_device)).cpu(), ops.descramble(x))
    # the 9600 WPCR receiver's front half from blocks, streamed on the card
    # and on the CPU: the same symbol PDUs (lengths and clocks), their
    # values within 1e-5 (the discriminator's atan2 and complex product
    # round differently on the card)
    g3 = [b"BLOCKS ON THE CARD ONE", b"BLOCKS ON THE CARD TWO"]
    parts = [np.zeros(20_000, np.complex64)]
    for p in g3:
        parts += [ax25.g3ruh_modulate([np.frombuffer(p, np.uint8)], 50_000.0,
                                      device="cpu").numpy(), parts[0]]
    iq = np.concatenate(parts)
    outs = []
    for dev in (cuda_device, "cpu"):
        g, sink = Graph(), blocks.PduVectorSink()
        src = g.add(blocks.VectorSource(iq))
        x = g.add(blocks.RationalResampler(1, 1), src)
        power = g.add(blocks.SinglePoleIirFilter(0.01),
                      g.add(blocks.ComplexToMag2(), x))
        demod = g.add(blocks.QuadratureDemod(1.0), x)
        power = g.add(blocks.Skip(1), g.add(blocks.Delay(1), power))
        tagged = g.add(blocks.BurstTagger(0.01), demod, power)
        pdus = g.add(blocks.StreamToPdu("burst", 50_000, 50), tagged)
        g.add(sink, g.add(blocks.Wpcr(), g.add(blocks.Midpointer(), pdus)))
        g.run_stream(chunk_size=8192, device=dev)
        outs.append(sink.pdus())
    assert len(outs[0]) == len(outs[1]) == 2
    for a, b in zip(*outs):
        assert a.data.device.type == "cuda" and a.data.shape == b.data.shape
        assert [(t.key, t.val) for t in a.tags if t.key == "sps"] == \
            [(t.key, t.val) for t in b.tags if t.key == "sps"]
        torch.testing.assert_close(a.data.cpu(), b.data, atol=1e-5, rtol=0)


def _chip_smoke(monkeypatch):
    """chip_smoke.py of the repository root (its IL2P frame builder, kernel
    G's growing streams)."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


def test_torch_cuda_correlator_blocks_and_zero_crossing(cuda_device, monkeypatch):
    from rustradio_tpu_torch.ops.il2p import SYNC_WORD

    cs = _chip_smoke(monkeypatch)
    bits, ends, want = cs.il2p_bits(6, 1)
    x = torch.from_numpy(bits)
    got = ops.correlate_access_code(x.to(cuda_device), SYNC_WORD, 2)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), ops.correlate_access_code(x, SYNC_WORD, 2))
    # the tag block and the deframer streamed on the card, headers across
    # seams: the offline CPU run's tags and headers
    runs = []
    for dev, chunk in ((cuda_device, 700), ("cpu", None)):
        g, tags, pdus = Graph(), blocks.VectorSink(), blocks.PduVectorSink()
        tagged = g.add(blocks.CorrelateAccessCodeTag(SYNC_WORD),
                       g.add(blocks.VectorSource(x)))
        g.add(tags, tagged)
        dfr = blocks.Il2pDeframer()
        g.add(pdus, g.add(dfr, tagged))
        if chunk:
            g.run_stream(chunk_size=chunk, device=dev)
        else:
            g.run(device=dev)
        runs.append(([t.pos for t in tags.tags() if t.key == "sync"],
                     [(h.src, h.dst, h.describe()) for h in dfr.headers]))
    assert runs[0] == runs[1] == (ends, want)
    # the zero-crossing op: its mask on the card, native's symbols
    nrz = torch.from_numpy(np.repeat(bits * 2.0 - 1.0, 21).astype(np.float32))
    (v, m), st = ops.zero_crossing_sync(nrz.to(cuda_device), 20.8333)
    (_, cm), cst = ops.zero_crossing_sync(nrz, 20.8333)
    assert m.device.type == "cuda" and torch.equal(m.cpu(), cm) and st == cst


def test_torch_cuda_il2p_1200_rx_on_the_card(cuda_device, monkeypatch):
    cs = _chip_smoke(monkeypatch)
    bits, _, want = cs.il2p_bits(5, 2)
    iq = torch.from_numpy(cs.il2p_capture(bits, 2)).to(cuda_device)
    calls = _hold_calls(monkeypatch, ["fir_decimate"])
    got = ax25.il2p_1200_rx(iq, 50_000.0)
    # the channel filter (both planes), the band-pass, the Hilbert, the
    # low-pass: kernel A, each call held against its plain version
    assert len(calls["fir_decimate"]) == 4
    _held_fir(calls["fir_decimate"])
    assert [(h.src, h.dst, h.describe()) for h in got] == want
    assert [(h.src, h.dst, h.describe())
            for h in ax25.il2p_1200_rx(iq.cpu(), 50_000.0)] == want


def test_torch_cuda_sdr_apps_default_to_the_card(cuda_device, tmp_path,
                                                 monkeypatch, capsys):
    from rustradio_tpu_torch.apps import rtl_fm, scanner, soapy_fm
    from rustradio_tpu_torch.hw import SdrSource, SimDriver
    from rustradio_tpu_torch.io import au

    src = SdrSource(SimDriver(1e8, 1.024e6, tones=[(1e8 + 1e4, 0.5)]))
    assert src.emit(0, 1000, cuda_device).device.type == "cuda"
    calls = _hold_calls(monkeypatch, ["fir_decimate"])
    args = ["-r", "sim", "--seconds", "0.25"]
    assert rtl_fm.main(args + ["--out", str(tmp_path / "g.au")]) == 0  # the card
    assert calls["fir_decimate"] and calls["fir_decimate"][0][0].is_cuda
    _held_fir(calls["fir_decimate"])
    assert rtl_fm.main(args + ["--out", str(tmp_path / "c.au"), "--device",
                               "cpu"]) == 0
    got, want = (au.au_read(str(tmp_path / f))[0] for f in ("g.au", "c.au"))
    # kernel A's 2e-5 of max|y| through the discriminator at gain 2.17 on a
    # constant envelope, plus two PCM steps
    np.testing.assert_allclose(got[3:], want[3:], atol=2 * 2e-5 * 2.2 + 2 / 32767,
                               rtol=0)
    assert soapy_fm.main(["-d", "sim", "--seconds", "0.25", "-o",
                          str(tmp_path / "s.au")]) == 0
    capsys.readouterr()
    assert scanner.main(["-r", "sim", "--sample_rate", "2.048m", "--top", "2"]) == 0
    rows = [r.split()[:2] for r in capsys.readouterr().out.splitlines()[1:]]
    assert rows == [["25", "200.0k"], ["212", "-352.0k"]]


def test_torch_cuda_capturable_blocks_replay_their_chunks(cuda_device, monkeypatch):
    # every capturable block class alone (chip_smoke.py's cases, the ones
    # its phase 13 runs) over three batches of four chunks (13 chunks: the
    # first alone): one capture, three replays, each output equal to the
    # block's eager per-chunk output
    cs = _chip_smoke(monkeypatch)
    cases = cs.capturable_cases(blocks, np.random.RandomState(31))
    assert len(cases) == 21
    for case, make, ins, n_out in cases:
        inputs = ins(13 * 4096)
        want, _ = cs.run_capturable_case(cuda_device, make, inputs, n_out, 4096, None)
        got, g = cs.run_capturable_case(cuda_device, make, inputs, n_out, 4096, 4)
        assert [(e["nb"], e["replays"]) for e in g.capture_log] == [(4, 3)], case
        for a, b in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b), case


@pytest.mark.parametrize("scan", [4, 5])
def test_torch_cuda_batched_fm_chain_equals_per_chunk(cuda_device, tmp_path, scan):
    # the FM chain batched: each batch one replay, kernel B launched once a
    # chunk (the captures' warm-ups and recordings apart), the output bit
    # for bit the per-chunk run's; a run paused at a checkpoint and resumed
    # (the resumed states copied into the capture's) gives it too
    rng = np.random.RandomState(32)
    a, b = _fm_iq(rng, 4096 * 14 + 100, cuda_device)
    x = torch.complex(a, b)

    def run(scan, **kw):
        g, sink = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(x), blocks.FirFilter(_lp49(), deci=4),
                blocks.QuadratureDemod(1.0), blocks.MultiplyConst(0.5), sink)
        before = kernels.LAUNCHES["fm_chain"]
        g.run_stream(chunk_size=4096, device=cuda_device, scan_chunks=scan, **kw)
        return sink.data(), g, kernels.LAUNCHES["fm_chain"] - before

    want, _, n_want = run(None)
    got, g, n_got = run(scan)
    assert n_want == n_got == 15 and np.array_equal(got, want)
    # 14 full chunks: the first alone, then 4 + 4 + 4 and one alone, or
    # 5 + 5 + 3; the ragged tail alone
    caps = {(e["nb"], e["replays"]) for e in g.capture_log}
    assert caps == ({(4, 3)} if scan == 4 else {(5, 2), (3, 1)})
    ck = str(tmp_path / "c.ckpt")
    head, _, _ = run(scan, max_chunks=6, checkpoint_path=ck, checkpoint_every=3)
    tail, _, _ = run(scan, resume_from=ck)
    assert np.array_equal(np.concatenate([head, tail]), want)


# ---- kernels F and G: the recurrences, bit-equal to their plain versions

def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, every element (the kernels and the plain versions do
    the same f32 operations in the same order)."""
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _cma_input(rng, n):
    s = np.exp(2j * np.pi * rng.randint(0, 4, n + 2) / 4)
    x = 0.5 * s[:n] + 0.2 * np.exp(0.7j) * s[2:] + 0.01 * (rng.randn(n) + 1j * rng.randn(n))
    return torch.from_numpy(x.astype(np.complex64))


_CMA_K = kernels.CMA_BLOCK
# windows of a call: one, a block less one, a block, a block and one, and
# three tiles of 256 windows, five blocks and a ragged one
_CMA_NWIN = (1, _CMA_K - 1, _CMA_K, _CMA_K + 1, 3 * 256 + 5 * _CMA_K + 7)


@pytest.mark.parametrize("ntaps", [1, 2, 16, 31, 32, 33, 40, 64, 65, 100, 128])
@pytest.mark.parametrize("mu", [0.0, 1e-2])
def test_torch_cuda_cma_kernel_equals_plain(cuda_device, ntaps, mu):
    # kernel F against its plain version run on the card, from the default
    # and from given complex taps: taps past every lane count (1..4 a
    # lane), calls of one window to several tiles
    rng = np.random.RandomState(ntaps)
    taps0 = torch.from_numpy(((rng.randn(ntaps) + 1j * rng.randn(ntaps))
                              / (2 * ntaps)).astype(np.complex64))
    taps0[0] += 1.0
    for nwin in _CMA_NWIN:
        x = _cma_input(rng, nwin + ntaps - 1).to(cuda_device)
        for t in (None, taps0.to(cuda_device)):
            before = kernels.LAUNCHES["cma"]
            y, fin = ops.cma_equalize(x, ntaps, 1.0, mu, taps=t)
            assert kernels.LAUNCHES["cma"] == before + 1
            t0 = torch.eye(1, ntaps, dtype=torch.complex64, device=cuda_device)[0]
            wy, wfin = kernels.cma_scan_plain(x, t0 if t is None else t, 1.0, mu)
            assert y.shape == (nwin,)
            assert _same(y, wy) and _same(fin, wfin), nwin
            assert torch.isfinite(torch.view_as_real(y)).all()


def test_torch_cuda_cma_long_call_and_block_edges(cuda_device):
    # 2^20 windows: the first 2^14 outputs are the plain version's; a call
    # split after a multiple of the block, the taps carried, is the one
    # call bit for bit, and its second part the plain version's
    nwin, win, ntaps = 1 << 20, 1 << 14, 16
    x = _cma_input(np.random.RandomState(11), nwin + ntaps - 1).to(cuda_device)
    y, fin = ops.cma_equalize(x, ntaps, 1.0, 1e-3)
    t0 = torch.eye(1, ntaps, dtype=torch.complex64, device=cuda_device)[0]
    wy, _ = kernels.cma_scan_plain(x[: win + ntaps - 1], t0, 1.0, 1e-3)
    assert _same(y[:win], wy)
    cut = nwin - win
    assert cut % _CMA_K == 0
    y1, t1 = ops.cma_equalize(x[: cut + ntaps - 1], ntaps, 1.0, 1e-3)
    y2, t2 = ops.cma_equalize(x[cut:], ntaps, 1.0, 1e-3, taps=t1)
    assert _same(torch.cat([y1, y2]), y) and _same(t2, fin)
    wy, wfin = kernels.cma_scan_plain(x[cut:], t1, 1.0, 1e-3)
    assert _same(y2, wy) and _same(t2, wfin)
    assert torch.isfinite(torch.view_as_real(y)).all()


@pytest.mark.parametrize("nwin", [_CMA_K + 1, 3 * 256 + 5 * _CMA_K + 7])
def test_torch_cuda_cma_unaligned_input(cuda_device, nwin):
    # x off a 16-byte boundary: kernel F stages it in 8-byte copies
    ntaps = 16
    base = _cma_input(np.random.RandomState(nwin), nwin + ntaps).to(cuda_device)
    x = base[1:]
    assert x.data_ptr() % 16 == 8
    y, fin = ops.cma_equalize(x, ntaps, 1.0, 1e-2)
    t0 = torch.eye(1, ntaps, dtype=torch.complex64, device=cuda_device)[0]
    wy, wfin = kernels.cma_scan_plain(x, t0, 1.0, 1e-2)
    assert _same(y, wy) and _same(fin, wfin)
    ya, fa = ops.cma_equalize(x.clone(), ntaps, 1.0, 1e-2)
    assert _same(y, ya) and _same(fin, fa)


@pytest.mark.parametrize("ntaps", [1, 5, 128])
def test_torch_cuda_cma_one_window_and_passthrough(cuda_device, ntaps):
    rng = np.random.RandomState(7)
    x = _cma_input(rng, ntaps)
    y, fin = ops.cma_equalize(x.to(cuda_device), ntaps, 1.0, 1e-2)
    wy, wfin = ops.cma_equalize(x, ntaps, 1.0, 1e-2)
    assert y.shape == (1,) and _same(y, wy) and _same(fin, wfin)
    # mu = 0 with the default taps is an exact passthrough (tests/test_graph.py:268)
    x = _cma_input(rng, 5000)
    y, fin = ops.cma_equalize(x.to(cuda_device), ntaps, 1.0, 0.0)
    assert _same(y, x[: 5000 - ntaps + 1])
    assert _same(fin, torch.eye(1, ntaps, dtype=torch.complex64)[0])


def test_torch_cuda_cma_over_limit_raises(cuda_device):
    x = torch.ones(300, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="1..128 taps"):
        ops.cma_equalize(x, kernels.MAX_CMA_TAPS + 1)


def test_torch_cuda_cma_equalizer_streams_on_the_card(cuda_device):
    x = _cma_input(np.random.RandomState(3), 20_000)

    def run(chunk):
        g, s = Graph(), blocks.VectorSink()
        g.chain(blocks.VectorSource(x), blocks.CmaEqualizer(16, 1.0, 1e-3), s)
        if chunk is None:
            g.run(device=cuda_device)
        else:
            g.run_stream(chunk_size=chunk, device=cuda_device)
        return s.data()

    whole = run(None)
    assert len(whole) == 20_000 - 15
    for chunk in (7, 1024, 4096):
        # the calls the block makes, one a chunk, the taps and the last 15
        # samples carried, bit for bit; the one call within 1e-5 of max|y|
        # (kernel F's blocks of windows count from each call's start)
        got = run(chunk)
        taps, buf, want = torch.eye(1, 16, dtype=torch.complex64)[0], x[:0], []
        for lo in range(0, len(x), chunk):
            buf = torch.cat([buf, x[lo : lo + chunk]])
            if buf.shape[0] >= 16:
                y, taps = kernels.cma_scan_plain(buf, taps, 1.0, 1e-3)
                want.append(y.numpy())
                buf = buf[-15:]
        assert np.array_equal(got, np.concatenate(want)), chunk
        assert np.abs(got - whole).max() <= 1e-5 * np.abs(whole).max(), chunk


_IIR_TAPS = {
    1: [0.1, 0.9],
    2: [0.05, 1.6, -0.65],
    # poles 0.95 e^{+-0.3j}, 0.9 e^{+-0.9j}, 0.85 e^{+-1.6j}, 0.8 e^{+-2.4j}
    8: [0.3017025, 1.7045681, -1.5572132, 1.1628689, -0.8696898, 0.672317,
        -0.5769415, 0.500414, -0.33802596],
}


def _iir_taps(order, rng):
    if order in _IIR_TAPS:
        return np.asarray(_IIR_TAPS[order], np.float32)
    # a stable filter of any order: taps[i] small enough that sum |taps| < 1
    t = rng.uniform(-1, 1, order + 1)
    t[1:] *= 0.95 / np.abs(t[1:]).sum()
    return t.astype(np.float32)


_L, _B = kernels.IIR_CHUNK, kernels.IIR_BLOCK
# one sample; a chunk less one, a chunk, a chunk and one; more chunks than
# one with a tail; 300 chunks (three blocks); 2^16; 131 blocks (two tiles
# of the carries' scan); 2^20
_IIR_NS = [1, _L - 1, _L, _L + 1, 3 * _L + 5, 300 * _L - 17, 1 << 16,
           (_B + 2) * _B * _L + 77, 1 << 20]


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 31, 32])
def test_torch_cuda_iir_kernel_equals_plain(cuda_device, order):
    # kernel G against its plain version run on the card, bit for bit,
    # with and without history; one count a call
    rng = np.random.RandomState(order)
    taps = _iir_taps(order, rng)
    x = torch.from_numpy(rng.randn(max(_IIR_NS) + 3).astype(np.float32)).to(cuda_device)
    hist = torch.from_numpy(rng.randn(order).astype(np.float32)).to(cuda_device)
    zeros = torch.zeros(order, device=cuda_device)
    for n in _IIR_NS:
        for h in (None, hist):
            before = kernels.LAUNCHES["iir"]
            got = ops.iir_filter(x[:n], taps, h)
            assert kernels.LAUNCHES["iir"] == before + 1
            want = kernels.iir_scan_plain(x[:n], taps, zeros if h is None else h)
            assert _same(got, want), (n, h is None)
    # x off a 16-byte boundary: the staging's one-word path at full blocks
    n = 300 * _L - 17
    got = kernels.iir_scan(x[3 : 3 + n], taps, hist)
    assert _same(got, kernels.iir_scan_plain(x[3 : 3 + n], taps, hist))


@pytest.mark.parametrize("kind", ["marginal", "outside"])
def test_torch_cuda_iir_growing_filters_equal_plain(cuda_device, kind):
    # the goldens' marginal filter (a pole at z = 1) and a pole pair just
    # outside the unit circle (radius 1.0002, finite over these lengths):
    # their carries do not fade, so every pass's order shows in the outputs
    taps = np.asarray([1.0, 0.9, 0.1] if kind == "marginal" else
                      [1.0, 2 * 1.0002 * np.cos(0.3), -1.0002 ** 2], np.float32)
    rng = np.random.RandomState(len(kind))
    ns = ([300 * _L - 17, (_B + 2) * _B * _L + 77, 1 << 20] if kind == "marginal"
          else [300 * _L - 17, 1 << 16])
    x = torch.from_numpy(rng.randn(max(ns)).astype(np.float32)).to(cuda_device)
    for n in ns:
        for h in (torch.zeros(2), torch.from_numpy(rng.randn(2).astype(np.float32))):
            h = h.to(cuda_device)
            got = kernels.iir_scan(x[:n], taps, h)
            want = kernels.iir_scan_plain(x[:n], taps, h)
            assert bool(torch.isfinite(want).all()) and _same(got, want), n


@pytest.mark.parametrize("case", range(6))
def test_torch_cuda_iir_growing_streams_equal_plain(cuda_device, monkeypatch, case):
    # chip_smoke.py's streams through growing filters, whose f32 powers
    # overflow (2^18 samples): kernel G bit-equal to its plain version (NaN
    # where it is NaN), both finite wherever the sequential f32 recurrence
    # is, to within 4 samples of its first non-finite output
    cs = _chip_smoke(monkeypatch)
    what, taps, x, hist = cs.iir_growing_streams(1 << 18)[case]
    got = kernels.iir_scan(x.to(cuda_device), taps, hist.to(cuda_device))
    want = kernels.iir_scan_plain(x.to(cuda_device), taps, hist.to(cuda_device))
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan), what
    assert torch.equal(got[~nan].cpu(), want[~nan].cpu()), what
    seq = cs.first_non_finite(cs.iir_sequential(x, taps, hist))
    end = cs.first_non_finite(got)
    assert (end is None) == (seq is None) and (seq is None or abs(end - seq) <= 4), what
    if what.startswith("zeros"):
        assert not got.cpu().any(), what


def test_torch_cuda_iir_layout_and_graph_capture(cuda_device):
    # the wrapper's mirror of the kernel's layout; a call captured in a
    # CUDA graph (no host sync, no allocation in the kernel) replays
    # bit-equal to the eager call
    from rustradio_tpu_torch.ops import cuda_lib
    import ctypes
    out = (ctypes.c_int * 3)()
    cuda_lib.load().rr_iir_layout(out)
    assert list(out) == [kernels.IIR_CHUNK, kernels.IIR_BLOCK, kernels.IIR_LEVELS]
    taps = np.asarray(_IIR_TAPS[8], np.float32)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1 << 20).astype(np.float32)).to(cuda_device)
    hist = torch.zeros(8, device=cuda_device)
    eager = kernels.iir_scan(x, taps, hist)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        kernels.iir_scan(x, taps, hist)  # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out_g = kernels.iir_scan(x, taps, hist)
    x.copy_(torch.from_numpy(rng.randn(1 << 20).astype(np.float32)))
    g.replay()
    torch.cuda.synchronize()
    assert _same(out_g, kernels.iir_scan(x, taps, hist))
    assert not _same(out_g, eager)


def test_torch_cuda_iir_goldens_order_zero_and_limit(cuda_device):
    # reference src/iir_filter.rs:171-194
    got = ops.iir_filter(torch.full((4,), 100.0, device=cuda_device), [1.0, 0.9, 0.1])
    assert got.cpu().tolist() == np.float32([100.0, 190.0, 281.0, 371.9]).tolist()
    got = ops.iir_filter(torch.tensor([100.0, 100.0, 200.0], device=cuda_device),
                         [1.0, 0.9, 0.1], history=[100.0, 100.0])
    assert got.cpu().tolist() == [200.0, 290.0, 481.0]
    before = dict(kernels.LAUNCHES)
    x = torch.randn(100, device=cuda_device)
    assert torch.equal(ops.iir_filter(x, [0.7]), x * np.float32(0.7))
    assert kernels.LAUNCHES == before  # order 0 launches nothing
    assert ops.iir_filter(x[:0], [0.5, 0.5]).shape == (0,)
    with pytest.raises(ValueError, match="orders 1..32"):
        ops.iir_filter(x, np.full(kernels.MAX_IIR_ORDER + 2, 0.01))


@pytest.mark.parametrize("program", ["bench_kernels", "bench", "check_fm_accuracy"])
def test_torch_cuda_bench_programs_at_small_sizes(cuda_device, capsys, program):
    # the benchmark programs' card path at their small sizes: every row
    # correct and timed; where a kernel carries a row, launched and bounded
    import importlib
    import json

    mod = importlib.import_module(f"rustradio_tpu_torch.tools.{program}")
    assert mod.main(["--small"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    rows = lines[0]["rows"].values() if program == "bench" else lines
    assert lines and all(line["platform"] == "gpu" and line["correct"]
                         and line["card"] == torch.cuda.get_device_name(0)
                         for line in lines)
    for row in rows:
        assert row["ms"] > 0 and row["correct"]
        assert (row["launches"] is None) == (row["bound_ms"] is None)
        assert row["launches"] is None or (row["launches"] >= 1
                                           and row["device_ms"] > 0)
