"""The burst receiver ``models.ax25.ax25_1200_wpcr_rx`` held against the
plain float64 reference ``tools/wpcr_reference.py`` on the CPU, on a
seeded 2^18-sample 50 kHz capture of 6 frames made as the benchmark's
burst cell makes it (``radiobench/generators/afsk_iq_bursts.py``): the
AFSK discriminator stream, the burst cuts, each burst's clock and the
delivered payloads.  Also the reference alone (its CRC check value, its
best-bin rule by hand, its deframer on a framed payload), the receiver's
spans and counter, and the app's closing line.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radiobench.generators import make_inputs
from radiobench.harness import load_cell
from radiobench.reference import hdlc as bench_hdlc
from rustradio_tpu_torch.apps import ax25_1200_wpcr
from rustradio_tpu_torch.models import ax25
from rustradio_tpu_torch.ops.burst import burst_cuts, burst_tagger
from rustradio_tpu_torch.ops.wpcr import TOTALS, _rows, wpcr_batch
from rustradio_tpu_torch.tools import wpcr_reference as ref

FS = 50_000.0
SEED = 2_147_483_659  # past 32 signed bits
# the widest gap of the port's discriminator stream (f32: two 1205-tap
# filters, two discriminators, the Hilbert) to the float64 reference's,
# over the reference's RMS: 1.7e-5 to 4.4e-5 on three seeds; f32 rounds at
# 6e-8 of each value and the sums of 1205 taps and the second
# discriminator grow that, while one bit less in the front-end's f32
# (bfloat16, 2^-8) would read 1e-3 or more
STREAM_TOL = 5e-4
# each burst's clock phase (the turns of the symbol clock at its first
# sample) to the reference's: the port rounds it to f32 (an ulp at 1.5 is
# 1.2e-7) from the same transitions (the same best bin, whose angle both
# compute in complex128); a transition moved by one sample would move it
# by ~1e-3 of a turn
PHASE_TOL = 1e-5


def _capture(samples: int, frames: int, seed: int = SEED) -> dict:
    cell = load_cell("aprs1200_wpcr.bursts")
    cell.traffic.update(samples=samples, frames=frames)
    return make_inputs(cell.traffic, cell.config, seed, "cpu")


@pytest.fixture(scope="module")
def capture():
    """The capture, the port's intermediate streams and cuts, and the
    reference's whole run."""
    x = _capture(1 << 18, 6)
    power, fm = ax25._burst_front(x["iq"], FS, FS, 20_000.0, 0.01)
    nrz = ax25._afsk_discriminator(fm, FS, 2400.0)
    n = min(power.shape[0], nrz.shape[0])
    cuts, too_long = burst_cuts(*burst_tagger(power[:n], 1e-4), n, int(FS), 50)
    return {"x": x, "nrz": nrz, "cuts": cuts, "too_long": too_long,
            "ref": ref.receive(x["iq"], FS)}


@pytest.fixture(scope="module")
def short():
    """A shorter capture of 2 frames for the spans and the app."""
    return _capture(1 << 17, 2, seed=5)


def test_torch_wpcr_rx_discriminator_stream_against_float64(capture):
    want = capture["ref"]["nrz"]
    got = capture["nrz"].double()
    assert got.shape == want.shape
    rms = want.pow(2).mean().sqrt()
    assert float((got - want).abs().max() / rms) < STREAM_TOL


def test_torch_wpcr_rx_burst_cuts_equal(capture):
    r = capture["ref"]
    assert capture["cuts"] == r["cuts"] and capture["too_long"] == r["too_long"]
    assert len(r["cuts"]) >= 4


def test_torch_wpcr_rx_each_burst_clock_equal(capture):
    nrz, r = capture["nrz"], capture["ref"]
    res = wpcr_batch([nrz[a:b] for a, b in capture["cuts"]])
    assert [b["cut"] for b in r["bursts"]] == capture["cuts"]
    for (_, info), want in zip(res, r["bursts"]):
        assert info["found"] == ("bin" in want)
        if not info["found"]:
            continue
        assert info["bin"] == want["bin"]
        assert np.float32(info["sps"]) == np.float32(want["sps"])
        assert abs(info["phase"] - want["phase"]) < PHASE_TOL


def test_torch_wpcr_rx_delivers_the_references_payloads(capture):
    x, r = capture["x"], capture["ref"]
    got = [bytes(p) for p in ax25.ax25_1200_wpcr_rx(x["iq"], FS)]
    assert got == r["frames"]
    assert len(got) >= 3 and set(got) <= set(x["truth"]["payloads"])


def test_torch_wpcr_rx_counts_a_call(capture):
    x, r = capture["x"], capture["ref"]
    before = dict(TOTALS)
    got = ax25.ax25_1200_wpcr_rx(x["iq"], FS)
    d = {k: TOTALS[k] - before[k] for k in TOTALS}
    lengths = [b - a for a, b in r["cuts"]]
    found = sum("bin" in b for b in r["bursts"])
    assert d["calls"] == 1
    assert d["bursts"] == len(lengths) + r["too_long"]
    assert (d["too_long"], d["too_short"], d["found"]) == (r["too_long"], 0, found)
    assert d["decoded"] == len(got) == len(r["frames"])
    assert d["rows"] == len(lengths) and d["burst_samples"] == sum(lengths)
    # each bucket: its bursts' rows rounded up to m x 2^k with m <= 16,
    # times the power of two at or above its longest burst
    buckets: dict[int, int] = {}
    for n in lengths:
        L = 1 << max(6, (n - 1).bit_length())
        buckets[L] = buckets.get(L, 0) + 1
    rows = {L: _four_bits(c) for L, c in buckets.items()}
    assert d["buckets"] == len(buckets)
    assert d["rows_padded"] == sum(rows.values())
    assert d["padded_samples"] == sum(L * c for L, c in rows.items())


def _four_bits(count: int) -> int:
    """The least m x 2^k at or above ``count`` with m <= 16."""
    return min(m << k for k in range(24) for m in range(1, 17)
               if m << k >= count)


@pytest.mark.parametrize("count", [1, 7, 16, 17, 33, 246, 256, 257, 260,
                                   858, 872, 1025])
def test_torch_wpcr_rows_keep_four_significant_bits(count):
    # a bucket's rows: under 1/8 of padding, so a count that crosses a
    # power of two adds rows in proportion (246 and 260 bursts: 256 and
    # 288 rows, where a power of two gave 256 and 512)
    rows = _rows(count)
    assert rows == _four_bits(count)
    assert count <= rows < count * 9 / 8 or rows == count


def _bursts_of_frames(seed: int, g3ruh: bool) -> list:
    """Symbol bursts (+-1 f32), each keyed from a fresh line state and,
    for G3RUH, a fresh scrambler: a frame with one flag from the burst's
    first bit, a frame with a payload bit flipped, and a frame cut in two
    bursts (which one chain over both would join), between random bits."""
    from rustradio_tpu_torch.ops import nrzi
    from rustradio_tpu_torch.ops.scramble import scramble

    g = np.random.default_rng(seed)

    def noise():
        return g.integers(0, 2, int(g.integers(1, 40))).astype(np.uint8)

    raws = []
    for k in range(4):
        payload = f"N0CALL>APRS:burst {seed} {k}".encode()
        framed = bench_hdlc.hdlc_frame(bench_hdlc.fcs_add(payload), 1)
        flipped = framed.copy()
        flipped[40] ^= 1
        half = len(framed) // 2
        raws += [np.concatenate([framed, noise()]),
                 np.concatenate([noise(), flipped, noise()]),
                 np.concatenate([noise(), framed[:half]]),
                 np.concatenate([framed[half:], noise()])]
    bursts = []
    for raw in raws:
        bits = torch.from_numpy(raw)
        if g3ruh:
            bits = scramble(bits)[0]
        bursts.append(2.0 * nrzi.nrzi_encode(bits).float() - 1.0)
    return bursts


def _lengths(bursts) -> np.ndarray:
    return np.asarray([len(b) for b in bursts], np.int64)


@pytest.mark.parametrize("g3ruh", [False, True])
def test_torch_burst_stream_is_each_bursts_fresh_chain(g3ruh):
    # the deframer's stream: per burst, _APART ones and the bits of a fresh
    # slicer, NRZI decoder and (G3RUH) descrambler
    from rustradio_tpu_torch.ops import nrzi
    from rustradio_tpu_torch.ops.elementwise import binary_slicer
    from rustradio_tpu_torch.ops.scramble import descramble

    found = _bursts_of_frames(7, g3ruh)
    parts, firsts, at = [], [], 0
    for s in found:
        b = nrzi.nrzi_decode(binary_slicer(s))
        b = descramble(b) if g3ruh else b
        parts += [torch.ones(ax25._APART, dtype=torch.uint8), b]
        firsts.append(at + ax25._APART)
        at += ax25._APART + len(b)
    stream, got = ax25._burst_stream(torch.cat(found), _lengths(found), g3ruh)
    assert torch.equal(stream, torch.cat(parts))
    assert got.tolist() == firsts


@pytest.mark.parametrize("g3ruh", [False, True])
@pytest.mark.parametrize("fix_bits", [False, True])
def test_torch_burst_frames_match_a_fresh_chain_per_burst(g3ruh, fix_bits):
    # one slicer, NRZI, descrambler and deframer over all the bursts give
    # each burst's frames, positions and counts as a fresh chain per burst
    from rustradio_tpu_torch.ops import hdlc, nrzi
    from rustradio_tpu_torch.ops.elementwise import binary_slicer
    from rustradio_tpu_torch.ops.scramble import descramble

    found = _bursts_of_frames(5 + g3ruh, g3ruh)
    before = dict(hdlc.TOTALS)
    want, decoded = [], 0
    for s in found:
        b = nrzi.nrzi_decode(binary_slicer(s))
        got = ax25._packets(descramble(b) if g3ruh else b, fix_bits)
        decoded += bool(got)
        want += [(bytes(p), p.bit_pos) for p in got]
    mid = dict(hdlc.TOTALS)
    packets, n = ax25._burst_frames(torch.cat(found), _lengths(found),
                                    fix_bits, g3ruh)
    after = dict(hdlc.TOTALS)
    assert [(bytes(p), p.bit_pos) for p in packets] == want
    assert n == decoded >= 2
    assert {k: after[k] - mid[k] for k in after} == \
        {k: mid[k] - before[k] for k in mid}
    assert ax25._burst_frames(torch.zeros(0), _lengths([]), fix_bits,
                              g3ruh) == ([], 0)


def test_torch_wpcr_rx_spans_nest_in_the_call(short):
    x = short
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ax25.ax25_1200_wpcr_rx(x["iq"], FS)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("rr::")]
    names = {s[0] for s in spans}
    assert {"rr::wpcr.rx", "rr::wpcr.front", "rr::wpcr.cut", "rr::wpcr.clock",
            "rr::wpcr.bits", "rr::hdlc.deframe", "rr::ax25.packets"} <= names
    (_, t0, t1), = [s for s in spans if s[0] == "rr::wpcr.rx"]
    assert all(t0 <= a <= b <= t1 for _, a, b in spans)
    # the kernel-time metrics match kernels by "symbol_sync": no span may
    assert not any("symbol_sync" in n for n in names)


# ---- the reference alone

def test_wpcr_reference_crc16_x25_check_value():
    assert ref.crc16_x25(b"123456789") == 0x906E
    assert ref.crc16_x25(b"123456789") == bench_hdlc.crc16_x25(b"123456789")


@pytest.mark.parametrize("mag,want", [
    ([9, 9, 1, 5, 4, 10, 3], 5),        # the peak: 10 > 0.8 x 10, above 3
    ([0, 0, 1, 9, 9.5, 2], 4),          # 9 is over 7.6 but rising: 9.5
    ([50, 50, 8.5, 7, 10, 1], 2),       # bins 0, 1 are skipped; 8.5 > 8
    ([0, 0, 1, 2, 3], None),            # the last bin is never taken
    ([5, 5], None),                      # no bin from 2
])
def test_wpcr_reference_best_bin_by_hand(mag, want):
    assert ref.best_bin(torch.tensor(mag, dtype=torch.float64)) == want


def test_wpcr_reference_deframes_a_framed_payload():
    payload = b"N0CALL>APRS,WIDE2-1:>the reference's own deframer"
    line = bench_hdlc.nrzi_line(bench_hdlc.hdlc_frame(payload, 4))
    assert ref.hdlc_deframe(ref.nrzi_decode(line)) == [payload]
    bad = ref.nrzi_decode(line).copy()
    bad[4 * 8 + 40] ^= 1  # a payload bit
    assert ref.hdlc_deframe(bad) == []


def test_wpcr_reference_iir_is_the_recurrence():
    x = torch.rand(1000, dtype=torch.float64)
    y, acc = [], 0.0
    for v in x.tolist():
        acc = 0.01 * v + 0.99 * acc
        y.append(acc)
    torch.testing.assert_close(ref.single_pole_iir(x, 0.01),
                               torch.tensor(y, dtype=torch.float64),
                               rtol=1e-12, atol=1e-15)


def test_wpcr_reference_convolve_is_the_sum():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3000, dtype=torch.complex128, generator=g)
    h = torch.randn(77, dtype=torch.float64, generator=g)
    want = torch.tensor([sum(h[k] * x[n - k] for k in range(77) if n - k >= 0)
                         for n in range(0, 3000, 97)])
    torch.testing.assert_close(ref.convolve(x, h, block=512)[::97], want,
                               rtol=1e-12, atol=1e-12)


def test_wpcr_reference_files_are_one_text():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert (root / "rustradio_tpu_torch/tools/wpcr_reference.py").read_text() == \
        (root / "radiobench/reference/wpcr_rx.py").read_text()


# ---- the app's closing line

def test_torch_ax25_1200_wpcr_app_closing_line(short, tmp_path, capsys):
    x = short
    path = tmp_path / "cap.c32"
    x["iq"].numpy().astype(np.complex64).tofile(path)
    assert ax25_1200_wpcr.main(["-r", str(path), "--device", "cpu",
                                "--no_prewarm"]) == 0
    got = [bytes(p) for p in ax25.ax25_1200_wpcr_rx(x["iq"], FS)]
    err = capsys.readouterr().err
    m = re.search(r"decoded (\d+) packets from (\d+) bursts \((\d+) too long, "
                  r"(\d+) clock found, (\d+) CRC failures\) in [0-9.]+ s", err)
    assert m, err
    decoded, bursts, too_long, found, crc = map(int, m.groups())
    assert decoded == len(got) >= 1
    assert bursts >= found >= decoded and too_long <= bursts and crc >= 0
