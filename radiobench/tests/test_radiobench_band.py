"""The wideband cell ``aprs_wideband.scan`` on the CPU: its check by hand,
its generator, its four metric readers on hand-made traces, a small run
that is correct and the same run with the timed path broken, which is
not.  On the card (marked ``cuda``, skipped without one): the control,
the receiver with each channel's label swapped for its neighbour's, and
the timed path's channelizer at the cell's full size against the float64
plain reference, with the same chain in bfloat16 beside it.

    python -m pytest radiobench/tests/test_radiobench_band.py -q
    python -m pytest radiobench/tests/test_radiobench_band.py -q -s -m cuda
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from radiobench import harness, trace
from radiobench.generators import afsk_band, afsk_frames, make_inputs
from radiobench.harness import ROOT, Window, load_cell
from radiobench.metrics import channelizer_roofline
from radiobench.reference import band_frames
from radiobench.run import run_cell

CELL = "aprs_wideband.scan"
# the cell at a size a CPU test holds: one short frame a station
SMALL = {"samples": 1 << 20, "frames_per_station": 1, "payload_bytes": [40, 40],
         "sync_flags": 4, "lead_samples": 10240, "ramp_samples": 2560}
SEED = 2_147_483_659  # past 32 signed bits
CARD_SEEDS = (2_300_000_021, 2_300_000_022, 2_300_000_023)
# the widest gap of the timed path's channelizer to the float64 DDC over
# the channel's RMS, at the cell's full size (see
# test_channelizer_against_float64_at_full_size).  f32 rounds each output
# at 2^-24 of its frame, whose magnitude the strongest station sets, so a
# noise channel 40 dB under it reads the widest share: 1.73e-5 on an H100;
# the same chain in bfloat16 reads 0.23.  The limit sits 58x above the one
# and 230x under the other
CHANNELIZER_LIMIT = 1e-3
S = trace.Span


def small_cell(**traffic):
    cell = load_cell(CELL)
    cell.traffic.update(SMALL, **traffic)
    return cell


# ---- the check by hand

def test_band_frames_by_hand():
    sent = [(13, b"a"), (13, b"b"), (110, b"c"), (14, b"d")]
    passes = [[(13, b"a"), (14, b"b"), (110, b"c"), (110, b"c")],
              [(13, b"a"), (13, b"b"), (110, b"c"), (14, b"d")]]
    due = [set(range(4))] * 2
    wrong, share, total, missed = band_frames.frame_numbers(passes, due, sent)
    # b on its neighbour's channel and c twice are wrong; b and d missed
    assert (wrong, total, missed) == (2, 8, 2)
    assert share == pytest.approx(100 * 2 / 8)


def test_band_judge_reads_the_cell_limits():
    cell = load_cell(CELL)
    assert cell.workload["limits"]["wrong_frames"] == 0
    assert 0 < cell.workload["limits"]["missed_pct"] <= 1.0

    class Run:
        limits = cell.workload["limits"]
        inputs = {"truth": {"frames": [(13, b"a"), (14, b"b")]}}
    w = Window(1.0, 2, 1, "pass", {"passes": [[(14, b"a"), (14, b"b")]],
                                   "due": [{0, 1}]})
    got = {c.name: (c.value, c.ok) for c in band_frames.judge(Run, w)}
    assert got == {"wrong_frames": (1.0, False), "missed_pct": (50.0, False)}


# ---- the generator

def test_band_channels_of_the_band_plan():
    config = load_cell(CELL).config
    assert afsk_band.channels(config) == [110, 13, 14, 15, 16, 17]
    with pytest.raises(ValueError, match="channel centre"):
        afsk_band.channels(dict(config, stations_hz=[144.4e6]))


def test_band_generator_modulates_the_frames_of_afsk_frames():
    """One station at 80 dB: the discriminator of the capture over each
    burst is the station's ``afsk_frames`` audio (framed by
    ``reference.hdlc``) at the deviation plus the carrier's offset from
    the channel's centre, and the carrier is off between the bursts."""
    cell = small_cell(cnr_db=[80.0], offsets_hz=[435], frames_per_station=2,
                      samples=1 << 21)
    cell.config.update(stations_hz=[145.01e6])
    x = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    t = x["truth"]
    assert t["channels"] == [13] and t["offsets_hz"] == [435]
    st = dict(cell.traffic, samples=x["n"], frames=2, amplitudes=[1.0],
              noises=[0.0])
    sent = afsk_frames.make(st, cell.config, afsk_band.station_seed(SEED, 0), "cpu")
    assert [p for _, p in t["frames"]] == sent["truth"]["payloads"]
    iq = x["iq"].to(torch.complex128)
    fm = torch.angle(torch.conj(iq[:-1]) * iq[1:])
    fs = cell.config["samp_rate"]
    want = 2 * math.pi * (cell.config["deviation_hz"] * sent["audio"][1:].double()
                          + 13 * fs / 128 + 435) / fs
    lead, ramp = cell.traffic["lead_samples"], cell.traffic["ramp_samples"]
    for a, b in zip(sent["truth"]["starts"], sent["truth"]["ends"]):
        burst = slice(int(a) + ramp, int(b) + lead - ramp)
        # 80 dB in 20 kHz is 59 dB over the band's noise a sample
        assert float((fm[burst] - want[burst]).abs().max()) < 0.02
    quiet = iq[: int(sent["truth"]["starts"][0])].abs()
    assert float(quiet.pow(2).mean().sqrt()) == pytest.approx(
        cell.traffic["noise_rms"], rel=0.02)


def test_band_generator_cnr_as_stated():
    """CNR in the station's 20 kHz channel: the carrier's power over the
    noise floor's share of one channel, sigma^2 / n_channels."""
    cell = small_cell(cnr_db=[15.0], offsets_hz=[-725], samples=1 << 21)
    cell.config.update(stations_hz=[144.39e6])
    x = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    t = afsk_frames.make(
        dict(cell.traffic, frames=1, amplitudes=[1.0], noises=[0.0]),
        cell.config, afsk_band.station_seed(SEED, 0), "cpu")["truth"]
    start, stop = int(t["starts"][0]), int(t["ends"][0]) + 1 + cell.traffic["lead_samples"]
    ramp = cell.traffic["ramp_samples"]
    p = x["iq"].abs().double().pow(2)
    noise = float(torch.cat([p[:start], p[stop:]]).mean())
    burst = float(p[start + ramp:stop - ramp].mean())
    cnr = 10 * math.log10((burst - noise) / (noise / 128))
    assert cnr == pytest.approx(15.0, abs=0.2)


def test_band_envelope_ramps_each_burst():
    """A raised cosine over each burst's first and last ramp samples, 1
    between, 0 outside the bursts."""
    env = afsk_band.envelope(np.array([2, 20]), np.array([12, 26]), 3, 30, "cpu")
    rise = [0.5 - 0.5 * math.cos(math.pi * k / 3) for k in (1, 2)]
    want = [0, 0, *rise, 1, 1, 1, 1, 1, 1, *rise[::-1], 0, 0] + [0] * 6 + \
        [*rise, 1, 1, *rise[::-1], 0, 0, 0, 0]
    np.testing.assert_allclose(env.numpy(), want, atol=1e-6)
    assert env.dtype == torch.float32


def test_band_seeds_permute_one_set():
    cell = small_cell()
    a = make_inputs(cell.traffic, cell.config, 1, "cpu")
    b = make_inputs(cell.traffic, cell.config, 2, "cpu")
    c = make_inputs(cell.traffic, cell.config, 1, "cpu")
    assert torch.equal(a["iq"], c["iq"]) and a["iq"].dtype == torch.complex64
    ta, tb = a["truth"], b["truth"]
    assert sorted(ta["cnr_db"]) == sorted(tb["cnr_db"]) == cell.traffic["cnr_db"]
    assert sorted(ta["offsets_hz"]) == sorted(tb["offsets_hz"])
    assert (ta["cnr_db"], ta["offsets_hz"]) != (tb["cnr_db"], tb["offsets_hz"])
    assert sorted(len(p) for _, p in ta["frames"]) == \
        sorted(len(p) for _, p in tb["frames"])
    assert ta["frames"] != tb["frames"]
    assert len({p for _, p in ta["frames"]}) == 6


# ---- the readers

def _pass(t0, ms=1e6):
    """One pass's host spans and device work from ``t0`` (ns): the
    channelizer's 3 kernels and the power's copy inside the stretch,
    kernel E after it."""
    host = [S("rr::band.rx", t0, t0 + 40 * ms),
            S("rr::band.channelize", t0 + 0.5 * ms, t0 + 1 * ms),
            S("rr::band.select", t0 + 1 * ms, t0 + 12 * ms),
            S("rr::band.demod", t0 + 12 * ms, t0 + 14.5 * ms),
            S("rr::band.bits", t0 + 30 * ms, t0 + 31 * ms),
            S("rr::hdlc.deframe", t0 + 31 * ms, t0 + 33 * ms),
            S("rr::hdlc.deframe", t0 + 33 * ms, t0 + 34 * ms),
            S("rr::band.packets", t0 + 34 * ms, t0 + 34.25 * ms)]
    device = [S("elementwise", t0 + 0.75 * ms, t0 + 6 * ms),
              S("elementwise", t0 + 5 * ms, t0 + 9 * ms),     # overlaps: 8.25
              S("regular_fft", t0 + 9.5 * ms, t0 + 10.5 * ms),  # 1
              S("Memcpy DtoH", t0 + 11 * ms, t0 + 11.75 * ms),  # 0.75
              S("symbol_sync_scan_kernel", t0 + 15 * ms, t0 + 29 * ms)]
    return host, device


def _trace(passes=2, lo=0.0):
    host, device = [], []
    for k in range(passes):
        h, d = _pass(lo + 1e6 + k * 50e6)
        host += h
        device += d
    return trace.Trace(device=device, host=host, lo=lo, hi=lo + passes * 50e6)


def test_channelizer_roofline_work_from_shapes():
    config = load_cell(CELL).config
    nbytes, flops = channelizer_roofline.work(1 << 28, config)
    assert nbytes == 16 * 2 ** 28
    assert flops == (4 * 8 + 5 * 7 + 3) * 2 ** 28


def test_channelizer_roofline_reads_the_front_half_stretch():
    tr = _trace()
    assert channelizer_roofline.stretches(tr) == [
        (1.5e6, 13e6), (51.5e6, 63e6)]
    ns, count = channelizer_roofline.front_half_ns(tr)
    assert count == 2 and ns == pytest.approx(2 * (8.25 + 1 + 0.75) * 1e6)
    # a stretch cut by the window's end is left out
    cut = _trace()
    cut.hi = 60e6
    assert channelizer_roofline.front_half_ns(cut) == (pytest.approx(10e6), 1)


def test_band_readers_on_a_hand_made_trace():
    tr = _trace()
    w = Window(seconds=0.1, samples=2, units=2, unit="pass")
    read = {n: harness.module("metrics", n).read for n in (
        "band_sync_ms_per_pass", "band_bank_host_ms_per_pass",
        "band_tail_ms_per_pass")}
    assert read["band_sync_ms_per_pass"](None, w, tr) == pytest.approx(14.0)
    assert read["band_bank_host_ms_per_pass"](None, w, tr) == pytest.approx(2.5)
    assert read["band_tail_ms_per_pass"](None, w, tr) == pytest.approx(4.25)


@pytest.mark.parametrize("name", ["channelizer_roofline", "band_sync_ms_per_pass",
                                  "band_bank_host_ms_per_pass",
                                  "band_tail_ms_per_pass"])
def test_band_readers_find_nothing_to_read(name):
    read = harness.module("metrics", name).read

    class Run:
        device = torch.device("cpu")
        inputs = {"n": 1 << 28}
        config = load_cell(CELL).config
    w = Window(seconds=0.1, samples=2, units=2, unit="pass")
    assert read(Run, w, None) is None
    # off the card: no device work (and, for the roofline, no card)
    tr = _trace()
    tr.device = []
    assert read(Run, w, tr) is None
    # a program without the wideband receiver's spans (the deframer's
    # own span and kernel E stay: the clock recovery still reads)
    bare = _trace()
    bare.host = [s for s in bare.host if s.name == "rr::hdlc.deframe"]
    got = read(Run, w, bare)
    assert (got is None) == (name != "band_sync_ms_per_pass")


# ---- runs on the CPU, sound and with the timed path broken

def test_a_small_band_run_is_correct():
    res = run_cell(small_cell(), SEED, 0.3, False, "cpu")
    assert res["correct"], [(c.name, c.value) for c in res["compared"]]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "msps_aprs"}
    assert len(res["window"].outputs["passes"][0]) == 6


def _decode(mp, alter):
    """The receiver's channels altered as ``decode_band_ax25`` returns
    them."""
    from rustradio_tpu_torch.models import multichannel

    real = multichannel.decode_band_ax25
    mp.setattr(multichannel, "decode_band_ax25",
               lambda *a, **k: alter(real(*a, **k)))


def _payload_altered(res):
    data = np.array(res[0].packets[0].data, np.uint8)
    data[len(data) // 2] ^= 0x20
    res[0].packets[0].data = data
    return res


def _neighbour(res):
    res[0].channel += 1
    return res


FAULTS = {
    "a payload altered": lambda mp: _decode(mp, _payload_altered),
    "a channel's frames dropped": lambda mp: _decode(mp, lambda res: res[1:]),
    "a frame on its neighbour's channel": lambda mp: _decode(mp, _neighbour),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_band_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_cell(small_cell(), SEED, 0.3, False, "cpu")
    assert not res["correct"]
    assert res["failed"] == res["attempted"]


def test_a_receiver_without_the_clock_filter_fails_in_set_up(monkeypatch):
    """The configuration states the receiver's clock filter: a program
    whose ``decode_band_ax25`` takes none raises before the window."""
    from rustradio_tpu_torch.models import multichannel

    real = multichannel.decode_band_ax25

    def no_clock_filter(iq, samp_rate, n_channels=64, baud=1200.0,
                        max_active=8, power_floor_db=-40.0, fix_bits=False,
                        sync_method="scan", device=None):
        return real(iq, samp_rate, n_channels, baud, max_active,
                    power_floor_db, fix_bits, sync_method, device=device)
    monkeypatch.setattr(multichannel, "decode_band_ax25", no_clock_filter)
    with pytest.raises(TypeError, match="symbol_taps"):
        run_cell(small_cell(), SEED, 0.3, False, "cpu")


# ---- on the card

@pytest.mark.cuda
def test_band_control_neighbour_labels_is_not_correct(card):
    for seed in CARD_SEEDS:
        cell = load_cell(CELL)
        cell.workload.setdefault("driver_args", {})["swap_neighbour_labels"] = True
        res = run_cell(cell, seed, 1.0, False, card)
        got = {c.name: c.value for c in res["compared"]}
        print(f"control seed {seed}: {got}")
        assert not res["correct"] and got["wrong_frames"] > 0


def _pfb_bfloat16(x, taps, m):
    """``pfb_channelize``'s chain with the capture, the taps and the
    branch sums in bfloat16 (real and imaginary planes: torch has no
    complex bfloat16), the inverse FFT in float32 (cuFFT has no
    bfloat16)."""
    import torch.nn.functional as F

    h = torch.from_numpy(np.asarray(taps, np.float32).reshape(-1, m)).to(
        x.device, torch.bfloat16)
    nframes = x.shape[0] // m
    out = []
    for plane in (x.real, x.imag):
        f = F.pad(plane.to(torch.bfloat16), (m - 1, 0))[: nframes * m] \
            .reshape(nframes, m).flip(1)
        acc = torch.zeros_like(f)
        for k in range(h.shape[0]):
            acc = acc + h[k] * F.pad(f, (0, 0, k, 0))[:nframes]
        out.append(acc.float())
    return torch.fft.ifft(torch.complex(*out), dim=1) * m


@pytest.mark.cuda
def test_channelizer_against_float64_at_full_size(card):
    """The timed path's channelizer (``pfb_channelize`` with the taps
    ``decode_band_ax25`` designs) on the cell's capture at its full size,
    against ``ddc_channels_f64`` computed in blocks: the widest gap over
    the channel's RMS.  The same chain in bfloat16 must fail the limit."""
    from rustradio_tpu_torch.parallel.channelizer import (channelizer_taps,
                                                          pfb_channelize)
    from rustradio_tpu_torch.tools.band_reference import ddc_channels_f64

    cell = load_cell(CELL)
    m = int(cell.config["n_channels"])
    x = make_inputs(cell.traffic, cell.config, CARD_SEEDS[0], card)["iq"]
    h = channelizer_taps(m, 8)
    got = {"float32": pfb_channelize(x, h, m)}
    got["bfloat16"] = _pfb_bfloat16(x, h, m)
    nframes = x.shape[0] // m
    power = torch.zeros(m, dtype=torch.float64, device=card)
    widest = {k: torch.zeros(m, dtype=torch.float64, device=card) for k in got}
    block = 1 << 16
    for a in range(0, nframes, block):
        b = min(a + block, nframes)
        ref = ddc_channels_f64(x, h, m, frames=(a, b))
        power += ref.abs().pow(2).sum(0)
        for k, y in got.items():
            gap = (y[a:b].to(torch.complex128) - ref).abs().amax(0)
            widest[k] = torch.maximum(widest[k], gap)
    rms = (power / nframes).sqrt()
    rel = {k: float((v / rms).max()) for k, v in widest.items()}
    line = {"samples": int(x.shape[0]), "channels": m, "seed": CARD_SEEDS[0],
            "widest_gap_over_rms": rel, "limit": CHANNELIZER_LIMIT,
            "worst_channel": {k: int((v / rms).argmax()) for k, v in widest.items()},
            "card": torch.cuda.get_device_name(card)}
    print(json.dumps(line))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "band_channelizer_f64.json").write_text(json.dumps(line) + "\n")
    assert rel["float32"] <= CHANNELIZER_LIMIT < rel["bfloat16"]
