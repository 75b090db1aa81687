"""The burst cell ``aprs1200_wpcr.bursts`` on the CPU: its check by hand,
its generator, its four metric readers on hand-made traces, a small run
that is correct, a traced one that reports no device metric, and the
same run with the timed path broken (a payload altered, half the frames
left out, each burst's clock at the nominal samples a symbol), which is
not.

    python -m pytest radiobench/tests/test_radiobench_wpcr.py -q
"""

from __future__ import annotations

import ast
import importlib
import math

import numpy as np
import pytest
import torch

from radiobench import harness, trace
from radiobench.drivers import ax25_wpcr
from radiobench.generators import afsk_iq_bursts, make_inputs
from radiobench.harness import BENCH_DIR, Window, load_cell
from radiobench.reference import hdlc, wpcr_frames
from radiobench.run import run_cell

CELL = "aprs1200_wpcr.bursts"
# the cell at a size a CPU test holds: 2^20 samples (21 s) and 8 frames,
# so that the gaps between frames are of the cell's order (~80,000
# samples on average; the cell's 1118 frames in 2^27 samples)
SMALL = {"samples": 1 << 20, "frames": 8}
SEED = 2_147_483_659  # past 32 signed bits
S = trace.Span
READERS = ("wpcr_cut_ms_per_pass", "wpcr_clock_ms_per_pass",
           "wpcr_tail_ms_per_pass", "wpcr_pad_pct")


def small_cell(**traffic):
    cell = load_cell(CELL)
    cell.traffic.update(SMALL, **traffic)
    return cell


# ---- the check by hand

def test_wpcr_gap_share_by_hand():
    passes = [[b"a", b"b", b"x"], [b"a", b"c"]]
    # pass 1: b and x only the program's, c only the reference's; pass 2: b
    assert wpcr_frames.gap_share(passes, {b"a", b"c"}, 4) == \
        pytest.approx(100 * (3 + 0) / 8)
    assert wpcr_frames.gap_share([[b"a"]], {b"a"}, 4) == 0.0


def test_wpcr_judge_reads_the_cell_limits(monkeypatch):
    cell = load_cell(CELL)
    limits = cell.workload["limits"]
    assert limits["wrong_frames"] == 0 and 0 < limits["ref_gap_pct"] <= 0.5

    class Run:
        inputs = {"truth": {"payloads": [b"a", b"b", b"c", b"d"]}, "iq": None}
        config = cell.config
    Run.limits = limits
    monkeypatch.setattr(wpcr_frames, "reference_frames",
                        lambda iq, config: {b"a", b"b"})
    w = Window(1.0, 2, 1, "pass", {"passes": [[b"a", b"b", b"b", b"z"]],
                                   "due": [{0, 1, 2, 3}]})
    got = {c.name: c.value for c in wpcr_frames.judge(Run, w)}
    # z never sent and b twice; c and d missed; z only the program's
    assert got == {"wrong_frames": 2.0, "missed_pct": 50.0, "ref_gap_pct": 25.0}


# ---- the generator

def test_wpcr_seeds_permute_one_set():
    cell = small_cell()
    a = make_inputs(cell.traffic, cell.config, 1, "cpu")
    b = make_inputs(cell.traffic, cell.config, 2, "cpu")
    c = make_inputs(cell.traffic, cell.config, 1, "cpu")
    assert torch.equal(a["iq"], c["iq"]) and a["iq"].dtype == torch.complex64
    ta, tb = a["truth"], b["truth"]
    for key in ("amplitudes", "offsets_hz", "drifts"):
        assert sorted(ta[key]) == sorted(tb[key])
        assert set(ta[key]) <= set(cell.traffic[key])
    assert (ta["amplitudes"], ta["offsets_hz"]) != (tb["amplitudes"], tb["offsets_hz"])
    assert sorted(map(len, ta["payloads"])) == sorted(map(len, tb["payloads"]))
    assert ta["payloads"] != tb["payloads"] and len(set(ta["payloads"])) == 8


def test_wpcr_generator_keys_the_carrier_with_the_tones():
    """Between the frames only the noise (of the traffic's total power);
    over each frame the discriminator reads the Bell 202 tones at the
    deviation plus the frame's carrier offset, and the carrier's power is
    its amplitude squared."""
    cell = small_cell(noise_power=1e-12, frames=3)
    x = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    t, iq = x["truth"], x["iq"].to(torch.complex128)
    fs = cell.config["samp_rate"]
    keyed = torch.zeros(len(iq), dtype=torch.bool)
    for k, (a, b) in enumerate(zip(t["starts"], t["ends"])):
        keyed[int(a):int(b) + 1] = True
        burst = iq[int(a):int(b) + 1]
        assert float(burst.abs().pow(2).mean()) == pytest.approx(
            t["amplitudes"][k] ** 2, rel=1e-4)
        fm = torch.angle(torch.conj(burst[:-1]) * burst[1:]) * fs / (2 * math.pi)
        # the tones swing +-3 kHz about the offset; their mean over whole
        # cycles is near it
        assert float(fm.abs().max()) < 3000 + abs(t["offsets_hz"][k]) + 5
        assert float(fm.mean()) == pytest.approx(t["offsets_hz"][k], abs=40)
    assert float(iq[~keyed].abs().max()) < 1e-4


def test_wpcr_generator_drifts_are_afsk_frames():
    """The drifts in the truth are those that set each frame's length:
    its line's bits times fs / (baud (1 + drift)) samples."""
    cell = small_cell()
    x = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    t = x["truth"]
    fs, baud = cell.config["samp_rate"], cell.config["baud"]
    for p, a, b, d in zip(t["payloads"], t["starts"], t["ends"], t["drifts"]):
        bits = len(hdlc.nrzi_line(hdlc.hdlc_frame(p, cell.traffic["sync_flags"])))
        assert int(b - a + 1) == int(bits * fs / (baud * (1.0 + d)))


def test_wpcr_generator_refuses_a_lead():
    cell = small_cell(lead_samples=735)
    with pytest.raises(ValueError, match="lead_samples"):
        make_inputs(cell.traffic, cell.config, SEED, "cpu")


# ---- the readers

def _pass(t0, ms=1e6):
    host = [S("rr::wpcr.rx", t0, t0 + 40 * ms),
            S("rr::wpcr.front", t0, t0 + 1 * ms),
            S("rr::wpcr.cut", t0 + 1 * ms, t0 + 11 * ms),
            S("rr::wpcr.clock", t0 + 11 * ms, t0 + 19 * ms),
            S("rr::wpcr.bits", t0 + 19 * ms, t0 + 21 * ms),
            S("rr::hdlc.deframe", t0 + 21 * ms, t0 + 22 * ms),
            S("rr::hdlc.deframe", t0 + 22 * ms, t0 + 23.5 * ms),
            S("rr::ax25.packets", t0 + 23.5 * ms, t0 + 24 * ms)]
    device = [S("fir_decimate_kernel", t0 + 0.5 * ms, t0 + 9 * ms)]
    return host, device


def _trace(passes=2):
    host, device = [], []
    for k in range(passes):
        h, d = _pass(1e6 + k * 50e6)
        host += h
        device += d
    # a deframer outside any receiver call is not the cell's tail
    host.append(S("rr::hdlc.deframe", 45e6, 48e6))
    return trace.Trace(device=device, host=host, lo=0.0, hi=passes * 50e6)


def _window(totals=None):
    return Window(seconds=0.1, samples=2, units=2, unit="pass",
                  outputs={"wpcr_totals": totals})


def test_wpcr_readers_on_a_hand_made_trace():
    tr = _trace()
    read = {n: harness.module("metrics", n).read for n in READERS}
    w = _window({"burst_samples": 300, "padded_samples": 400})
    assert read["wpcr_cut_ms_per_pass"](None, w, tr) == pytest.approx(10.0)
    assert read["wpcr_clock_ms_per_pass"](None, w, tr) == pytest.approx(8.0)
    assert read["wpcr_tail_ms_per_pass"](None, w, tr) == pytest.approx(5.0)
    assert read["wpcr_pad_pct"](None, w, tr) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_wpcr_readers_find_nothing_to_read(name):
    read = harness.module("metrics", name).read
    # untraced, and the parent's program: no counter, no span of its own
    assert read(None, _window(), None) is None
    bare = _trace()
    bare.host = [s for s in bare.host if not s.name.startswith("rr::wpcr.")]
    assert read(None, _window(), bare) is None
    if name != "wpcr_pad_pct":
        # off the card: a trace with no device work
        off = _trace()
        off.device = []
        assert read(None, _window(), off) is None


def test_wpcr_driver_reads_no_counter_where_the_program_has_none(monkeypatch):
    wpcr = importlib.import_module("rustradio_tpu_torch.ops.wpcr")
    assert isinstance(ax25_wpcr._totals(), dict)
    monkeypatch.delattr(wpcr, "TOTALS")
    assert ax25_wpcr._totals() is None


# ---- runs on the CPU, sound and with the timed path broken

def test_a_small_wpcr_run_is_correct():
    res = run_cell(small_cell(), SEED, 0.3, False, "cpu")
    assert res["correct"], [(c.name, c.value, c.limit) for c in res["compared"]]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "msps_aprs"}


def test_a_traced_wpcr_run_on_the_cpu_reports_no_device_metric():
    """Without a card the trace holds no device work: the span readers
    find nothing; the counter's padding share, which no device gives, is
    read."""
    res = run_cell(small_cell(), SEED, 0.3, True, "cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"wpcr_pad_pct"}
    assert 0 < res["metrics"]["wpcr_pad_pct"]["value"] < 100
    assert res["breakdown"]["device_ops"] == []


def _hdlc_deframe(mp, alter):
    """The receiver's frames altered where the deframer makes them."""
    from rustradio_tpu_torch.models import ax25

    real = ax25.hdlc.hdlc_deframe

    def deframe(*a, **k):
        packets, state = real(*a, **k)
        return alter(list(packets)), state
    mp.setattr(ax25.hdlc, "hdlc_deframe", deframe)


def _flip(pkts):
    if not pkts:
        return pkts
    data, pos = pkts[0]
    data = np.array(data, np.uint8)
    data[len(data) // 2] ^= 0x20
    return [(data, pos)] + pkts[1:]


def _every_other():
    """Drops every other frame it sees, over all its calls."""
    seen = [0]

    def drop(pkts):
        kept = [p for k, p in enumerate(pkts, seen[0]) if k % 2 == 0]
        seen[0] += len(pkts)
        return kept
    return drop


def nominal_clock(mp):
    """Each burst's clock at the nominal samples a symbol (fs / baud,
    41.67 at 50 kHz): the best bin's phase kept, its rate not."""
    wpcr = importlib.import_module("rustradio_tpu_torch.ops.wpcr")
    real = wpcr._rows_wpcr
    config = load_cell(CELL).config
    nominal = float(config["baud"]) / float(config["samp_rate"])

    def rows(v, m):
        mask, sps, phase, found, bin_, near = real(v, m)
        k = torch.arange(v.shape[1], device=v.device)
        sps = torch.full_like(sps, nominal)
        u = torch.floor(phase[:, None] + k.float()[None, :] * sps[:, None])
        first = (phase >= 1.0)[:, None]
        mask = torch.cat([first, u[:, 1:] > u[:, :-1]], 1)
        return mask & found[:, None] & (k[None, :] < m[:, None]), sps, phase, \
            found, bin_, near
    mp.setattr(wpcr, "_rows_wpcr", rows)


FAULTS = {
    "answer altered": lambda mp: _hdlc_deframe(mp, _flip),
    "half left out": lambda mp: _hdlc_deframe(mp, _every_other()),
    "nominal clock": nominal_clock,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_wpcr_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_cell(small_cell(), SEED, 0.3, False, "cpu")
    assert not res["correct"]
    assert res["failed"] == res["attempted"]


# ---- the yardstick stands alone

def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [
    "reference/wpcr_rx.py", "reference/wpcr_frames.py",
    "generators/afsk_iq_bursts.py", *(f"metrics/{n}.py" for n in READERS)])
def test_the_new_reference_files_import_nothing_of_the_program(path):
    got = _imports(BENCH_DIR / path)
    assert not got & {*harness.FORBIDDEN, "rustradio_tpu_torch"}, got
    if path == "reference/wpcr_rx.py":
        assert got <= {"__future__", "contextlib", "math", "numpy", "torch"}
