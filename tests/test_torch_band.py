"""The wideband 2 m receiver (``models.multichannel.decode_band_ax25``) at
the ``aprs2m_band_2560k`` deployment's shape, on the CPU: its channelizer
and discriminator against the float64 plain reference
(``tools/band_reference.py``), a short capture of the 2 m packet segment
at 2.56 Msps over 128 channels decoded frame for frame on its channels,
its spans under a CPU profiler and its counters.

The capture: six 1200 bd Bell 202 stations on the band plan's channels
(144.39 MHz and 145.01-145.09 MHz tuned at 144.75 MHz: channels 110 and
13-17), each a narrowband FM carrier at 3 kHz deviation, 145-725 Hz off
its channel's centre, with a clock drift of up to 1.5%, at 15-40 dB CNR
in its 20 kHz channel over a complex white noise floor, all six sending
at once.
"""

import inspect
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rustradio_tpu_torch import ops
from rustradio_tpu_torch.models import multichannel
from rustradio_tpu_torch.models.ax25 import ax25_1200_rx
from rustradio_tpu_torch.parallel.channelizer import channelizer_taps, pfb_channelize
from rustradio_tpu_torch.tools import band_reference
from rustradio_tpu_torch.utils import trace

FS = 2_560_000.0
M = 128
DEVIATION = 3000.0
# channel: (CNR dB in 20 kHz, carrier offset Hz, clock drift); the weakest
# between the two strongest, the strongest beside the channel 12 / 18 gaps
STATIONS = {110: (25.0, 725, 0.015), 13: (40.0, -725, -0.015),
            14: (15.0, 435, 0.01), 15: (35.0, -435, -0.01),
            16: (20.0, 145, 0.005), 17: (30.0, -145, -0.005)}
NOISE = 0.05  # complex RMS over the whole band
SPANS = {"rr::band.rx", "rr::band.channelize", "rr::band.select",
         "rr::band.demod", "rr::band.clock", "rr::band.compact",
         "rr::band.bits", "rr::band.packets"}
# f32 against float64: each channel sample is 8 products of the branch
# filter and a 128-point FFT, each step rounding at 2^-24 of the frame's
# magnitude, which on white noise is ~sqrt(M) channel RMS: the port reads
# up to ~5e-7 of the RMS; rounding the input alone to float16 (11 bits)
# reads ~9e-4 and to bfloat16 ~6e-3
CHANNELIZER_TOL = 1e-5


def _payload(k: int) -> bytes:
    return f"N0CALL-{k % 16}>APRS,WIDE2-1:>band {k:03d} {'x' * (k % 7)}".encode()


def _station(payload: bytes, k: int, cnr_db: float, offset: int, drift: float,
             n: int, start: int = 0, phase: float = 0.0) -> np.ndarray:
    """One station's burst: ``payload``'s frame (4 flags each side) as
    Bell 202 audio at FS (mark 1200 Hz, space 2200 Hz, tone phase
    ``phase``) from sample ``start``, frequency modulated onto channel k's
    centre plus ``offset`` Hz at ``cnr_db`` over ``NOISE``; the carrier
    drops 2048 samples after the frame."""
    framed = ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8)), 4)
    line = (1 + np.cumsum(1 - framed.astype(np.int64))) % 2
    sps = FS / (1200.0 * (1.0 + drift))
    tone = np.arange(int(len(line) * sps))
    freq = np.where(line[np.minimum((tone / sps).astype(int), len(line) - 1)]
                    == 1, 1200.0, 2200.0)
    audio = np.zeros(n)
    audio[start:start + len(tone)] = np.sin(2 * np.pi * np.cumsum(freq) / FS + phase)
    carrier = (k if k < M / 2 else k - M) * FS / M + offset
    cycles = carrier * np.arange(n) / FS + DEVIATION * np.cumsum(audio) / FS
    amp = NOISE * math.sqrt(10.0 ** (cnr_db / 10.0) / M)
    iq = amp * np.exp(2j * np.pi * cycles)
    iq[start + len(tone) + 2048:] = 0  # keyed: the carrier drops after the frame
    return iq


def _noise(n: int, rng) -> np.ndarray:
    return NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / math.sqrt(2)


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(22)
    n = 1 << 20  # 0.41 s: the frames take up to 0.33 s
    iq = _noise(n, rng)
    for k, (cnr, off, drift) in STATIONS.items():
        iq += _station(_payload(k), k, cnr, off, drift, n,
                       phase=rng.uniform(0, 2 * np.pi))
    return torch.from_numpy(iq.astype(np.complex64))


@pytest.fixture(scope="module")
def decoded(capture):
    before = dict(multichannel.TOTALS)
    res = multichannel.decode_band_ax25(capture, FS, n_channels=M, max_active=8,
                                        sync_method="scan")
    return res, {k: multichannel.TOTALS[k] - before[k] for k in before}


# ---- the channelizer and the discriminator against float64

@pytest.mark.parametrize("m", [16, 128])
def test_torch_pfb_channelize_matches_ddc_f64(m):
    rng = np.random.RandomState(m)
    n = m * 200 + m // 2 + 3  # not a multiple of m: the last samples drop
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    h = channelizer_taps(m, 8)
    got = pfb_channelize(x, h, m, device="cpu")
    want = band_reference.ddc_channels_f64(x, h, m)
    assert got.shape == want.shape == (n // m, m)
    rms = want.abs().pow(2).mean(0).sqrt()
    assert float(((got.to(torch.complex128) - want).abs() / rms).max()) \
        <= CHANNELIZER_TOL


def test_torch_ddc_f64_in_blocks_is_the_whole():
    """Blocks of output frames read only the samples they need and give
    the whole call's frames; the first block starts from zero history."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(16 * 90) + 1j * rng.randn(16 * 90)))
    h = channelizer_taps(16, 8)
    whole = band_reference.ddc_channels_f64(x, h, 16)
    parts = [band_reference.ddc_channels_f64(x, h, 16, frames=(a, min(a + 13, 90)))
             for a in range(0, 90, 13)]
    assert torch.equal(torch.cat(parts), whole)


def test_torch_bank_discriminator_matches_f64(capture):
    ch = pfb_channelize(capture[: M * 4096], channelizer_taps(M, 8), M)
    cols = ch[:, list(STATIONS)].T.contiguous()
    got = multichannel._discriminator(cols)
    want = band_reference.discriminator_f64(cols)
    assert got.dtype == torch.float32 and got.shape == want.shape == (6, 4095)
    # the f32 product and atan2 of each pair of samples: a few ulp of pi
    gap = torch.remainder(got.double() - want + math.pi, 2 * math.pi) - math.pi
    assert float(gap.abs().max()) <= 2e-6


# ---- the receiver

def test_torch_decode_band_2m_stations_on_their_channels(decoded):
    res, _ = decoded
    got = {r.channel: [bytes(p) for p in r.packets] for r in res}
    assert got == {k: [_payload(k)] for k in STATIONS}
    for r in res:
        assert r.freq == (r.channel if r.channel < M / 2 else r.channel - M) * 20e3


def test_torch_band_totals_count_one_call(decoded):
    res, delta = decoded
    # the bank takes the channels within 40 dB of the strongest, at most 8:
    # the six stations, which send all through the capture
    assert delta == {"calls": 1, "active": len(STATIONS), "rerun": 0,
                     "packets": len(STATIONS)}
    assert sum(len(r.packets) for r in res) == delta["packets"]


def test_torch_decode_band_takes_the_receivers_clock_filter():
    """A frame sent 1.5% fast at 40 dB: the bank's clock recovery with
    ``ax25_1200_rx``'s filter delivers it; with the JAX package's bank
    filter (0.5, 0.5) the clock slips on this frame's bits and the frame is
    lost (ROADMAP queue 3, item 16)."""
    rng = np.random.default_rng(12)
    payload = b"N0CALL>APRS:>" + bytes(rng.integers(0x20, 0x7F, 30).astype(np.uint8))
    n = 1 << 20
    start = 2048 + int(rng.integers(0, M))
    iq = _noise(n, rng) + _station(payload, 13, 40.0, 0, 0.015, n, start)
    x = torch.from_numpy(iq.astype(np.complex64))

    def delivered(**clock):
        res = multichannel.decode_band_ax25(x, FS, n_channels=M, **clock)
        return [(r.channel, bytes(p)) for r in res for p in r.packets]
    band = inspect.signature(multichannel.decode_band_ax25).parameters
    rx = inspect.signature(ax25_1200_rx).parameters
    for name in ("symbol_taps", "symbol_max_deviation"):
        assert band[name].default == rx[name].default
    assert delivered() == [(13, payload)]
    assert delivered(symbol_taps=(0.5, 0.5)) == []


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end, e.thread)
                 for e in prof.events() if e.name.startswith("rr::band.")]


def test_torch_band_spans_nest_once_in_the_call(capture):
    def one():  # a short capture and a bank of 2: few profiler events
        return multichannel.decode_band_ax25(capture[: M * 128], FS,
                                             n_channels=M, max_active=2)
    want = one()
    got, spans = _traced(one)
    assert [(r.channel, r.packets) for r in got] == \
        [(r.channel, r.packets) for r in want]
    assert sorted(s[0] for s in spans) == sorted(SPANS)
    (_, t0, t1, tid), = [s for s in spans if s[0] == "rr::band.rx"]
    for name, a, b, thread in spans:
        assert thread == tid and t0 <= a <= b <= t1, name
    # the clock recovery's kernel-time metric matches names on "symbol_sync"
    assert not any("symbol_sync" in s[0] for s in spans)


def test_torch_band_no_record_function_without_a_profiler(capture, monkeypatch):
    assert trace.span("band.rx") is trace._OFF

    def record_function(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    multichannel.decode_band_ax25(capture[: M * 256], FS, n_channels=M)
