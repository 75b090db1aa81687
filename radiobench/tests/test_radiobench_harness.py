"""The benchmark's own tests on the CPU: finding cells by name, the
metric arithmetic, the references against hand-made cases, the check for
JAX, and runs of every cell at small sizes with the timed path broken
underneath, where ``correct`` has to come out false.

    python -m pytest radiobench/tests -q
"""

from __future__ import annotations

import ast
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from radiobench import harness, trace
from radiobench.generators import make_inputs
from radiobench.harness import Window, load_cell, manifest
from radiobench.metrics import chain_roofline, msps
from radiobench.reference import ax25_frames, fm_chain, hdlc, taps
from radiobench.run import run_cell

BENCH = harness.BENCH_DIR

CELLS = [w["name"] for w in manifest()["workloads"]]

# each cell at a size a CPU test holds: traffic and driver arguments
SMALL = {
    "fm_rtl.capture": ({"samples": 1 << 15}, {}),
    "aprs1200.events": ({"samples": 500_000, "frames": 5}, {}),
}
SEED = 2_147_483_659  # past 32 signed bits


def small_cell(name: str):
    cell = load_cell(name)
    traffic, args = SMALL[name]
    cell.traffic.update(traffic)
    cell.workload.setdefault("driver_args", {}).update(args)
    return cell


# ---- finding things by name ----

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = load_cell(name)
    assert harness.module("drivers", cell.driver).window
    assert harness.module("reference", cell.check).judge
    for m in cell.end_to_end + cell.per_layer:
        assert harness.module("metrics", m["name"]).read
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_metric_names_a_reader_and_cell():
    man = manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in man["per_layer"]:
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    # each cell reports the metric its per-layer metrics move
    for name in CELLS:
        cell = load_cell(name)
        e2e = {e["name"] for e in cell.end_to_end}
        assert {m["moves"] for m in cell.per_layer} <= e2e


def test_a_new_workload_file_is_found_without_an_edit(tmp_path):
    """A cell added as data (an entry and a file) loads, in a copy of the
    checkout's benchmark files."""
    shutil.copytree(BENCH / "configs", tmp_path / "radiobench" / "configs")
    shutil.copytree(BENCH / "traffic", tmp_path / "radiobench" / "traffic")
    shutil.copytree(BENCH / "workloads", tmp_path / "radiobench" / "workloads")
    man = manifest()
    man["workloads"].append({"name": "fm_rtl.new", "config": "fm_rtl_1024k",
                             "traffic": "fm_capture_resident", "chips": 1,
                             "why": "a test"})
    (tmp_path / "radiobench" / "workloads" / "fm_rtl.new.json").write_text(
        json.dumps({"driver": "rtl_fm_capture",
                    "driver_args": {"precision": "i8", "resample": True},
                    "check": "fm_chain", "limits": {"max_err_rad": 1e-3}}))
    cell = load_cell("fm_rtl.new", man, root=tmp_path)
    assert cell.workload["driver_args"] == {"precision": "i8", "resample": True}
    assert cell.config["ntaps"] == 49
    # a metric scoped to some cells reaches the new one by its entry
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("msps", "device_idle_pct"):
            m["workloads"].append("fm_rtl.new")
    cell = load_cell("fm_rtl.new", man, root=tmp_path)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "msps"]
    assert [m["name"] for m in cell.per_layer] == ["device_idle_pct"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        load_cell("no.such.cell")


# ---- the metric arithmetic ----

def test_union_and_gaps_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert trace.union_ns(iv) == 15 + 11 + 1
    assert trace.union_ns(iv, 8, 25) == 7 + 5
    assert trace.gaps_ns(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    assert trace.gaps_ns([], 3, 7) == [(3, 7)]


def test_busy_share_idle_gaps_and_device_ops():
    S = trace.Span
    tr = trace.Trace(
        device=[S("k1", 10, 20), S("k2", 15, 30), S("k1", 60, 70), S("k3", 95, 120)],
        host=[S("rr::Blk", 0, 50), S("aten::x", 30, 45), S("py", 50, 100)],
        lo=0, hi=100)
    assert tr.busy_s() == pytest.approx(35e-9)  # k3 clipped at 100
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.device_ops() == [["k1", pytest.approx(20e-9)],
                               ["k2", pytest.approx(15e-9)],
                               ["k3", pytest.approx(5e-9)]]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # gaps: [0,10) in rr::Blk, [30,60) mid 45 in rr::Blk > aten::x,
    # [70,95) mid 82.5 in py
    assert gaps == {"rr::Blk": pytest.approx(10e-9),
                    "rr::Blk > aten::x": pytest.approx(30e-9),
                    "py": pytest.approx(25e-9)}


def test_msps_is_all_the_work_over_all_the_window():
    w = Window(seconds=2.5, samples=10_000_000, units=4, unit="pass")
    assert msps.read(None, w, None) == pytest.approx(4.0)


def test_chain_roofline_work_from_shapes():
    """At decimation 1 and 1.024 MHz to 48 kHz (3/64) the audio of n
    samples is ceil((n - 1) * 3 / 64), and each needs two filtered
    samples a plane."""
    config = load_cell("fm_rtl.capture").config
    n = 4096
    audio = -(-(n - 1) * 3 // 64)
    nbytes, flops = chain_roofline.work(n, config, True)
    assert audio == 192
    assert nbytes == 8 * n + 4 * audio
    assert flops == 2 * 2 * 49 * 2 * audio + 7 * audio
    # without a resampler every filtered sample is needed, once
    nbytes, flops = chain_roofline.work(n, dict(config, deci=4), False)
    assert nbytes == 8 * n + 4 * (n // 4 - 1)
    assert flops == 2 * 2 * 49 * (n // 4) + 7 * (n // 4 - 1)


def test_metric_readers_find_nothing_without_a_trace():
    w = Window(seconds=1.0, samples=1, units=1, unit="chunk")
    for name in ("device_idle_pct", "device_idle_pct_aprs",
                 "chain_roofline", "symbol_sync_ms_per_pass"):
        assert harness.module("metrics", name).read(None, w, None) is None


# ---- the references ----

def test_crc16_x25_check_value():
    assert hdlc.crc16_x25(b"123456789") == 0x906E
    assert hdlc.fcs_add(b"123456789")[-2:] == bytes([0x6E, 0x90])


def test_hdlc_frame_stuffs_and_flags():
    bits = hdlc.hdlc_frame(b"\xff", sync_flags=1)
    body = bits[8:-8]
    assert list(bits[:8]) == list(hdlc.FLAG) == list(bits[-8:])
    assert list(body[:6]) == [1, 1, 1, 1, 1, 0]  # a 0 after five 1s
    # no six 1s in a row between the flags
    run = best = 0
    for b in body:
        run = run + 1 if b else 0
        best = max(best, run)
    assert best <= 5


def test_nrzi_line_toggles_on_zero():
    assert list(hdlc.nrzi_line(np.array([0, 1, 1, 0, 0], np.uint8))) == \
        [0, 0, 0, 1, 0]


def test_channel_taps_as_published():
    t = taps.low_pass(1.024e6, 100e3, 50e3)
    assert len(t) == 49
    assert float(np.sum(t, dtype=np.float64)) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(t, t[::-1], rtol=1e-6)


def test_channel_taps_are_the_programs():
    """The frozen design gives the program's taps bit for bit."""
    from rustradio_tpu_torch import taps as program_taps

    want = np.real(program_taps.low_pass_complex(1.024e6, 100e3, 50e3, "hamming"))
    np.testing.assert_array_equal(taps.low_pass(1.024e6, 100e3, 50e3), want)


def test_fir_deci_against_a_loop():
    x = torch.randn(103, dtype=torch.float64)
    h = torch.randn(7, dtype=torch.float64)
    got = fm_chain.fir_deci(x, h, 4)
    want = [sum(float(h[j]) * float(x[m * 4 - j]) for j in range(7)
                if 0 <= m * 4 - j) for m in range(26)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_fm_chain_reads_a_steady_tone():
    """A complex tone of w rad a sample: every settled audio sample is
    deci * w * gain (the filter's gain is 1 there), and 10 kHz off the
    carrier is 10/75 of full deviation."""
    config = load_cell("fm_rtl.capture").config
    gain = fm_chain.audio_gain(config)
    assert gain == pytest.approx(1.024e6 / (2 * math.pi * 75e3))
    w = 2 * math.pi * 10e3 / config["samp_rate"]
    n = torch.arange(4096, dtype=torch.float64)
    out = fm_chain.fm_chain(torch.cos(w * n), torch.sin(w * n), config)
    assert len(out) == -(-4095 * 3 // 64)
    np.testing.assert_allclose(out[3:].numpy(), w * gain, atol=1e-9)
    np.testing.assert_allclose(out[3:].numpy(), 10 / 75, atol=1e-9)
    bf = fm_chain.fm_chain(torch.cos(w * n), torch.sin(w * n), config,
                           torch.bfloat16)
    assert fm_chain.widest_gap_rad(bf, out, gain) > 1e-3


def test_resample_index_is_rustradios_counter():
    """src/rational_resampler.rs: counter += interp a input; emit the
    input while counter > 0, counter -= deci each time."""
    for interp, deci, n in ((3, 64, 500), (64, 3, 40), (2, 3, 97), (1, 4, 33)):
        want, counter = [], 0
        for k in range(n):
            counter += interp
            while counter > 0:
                want.append(k)
                counter -= deci
        assert fm_chain.resample_index(n, interp, deci).tolist() == want
    assert fm_chain.resample_ratio(load_cell("fm_rtl.capture").config) == (3, 64)


def test_every_traffic_file_names_a_generator_file():
    for f in (BENCH / "traffic").glob("*.json"):
        name = json.loads(f.read_text())["generator"]
        assert harness.module("generators", name).make


def test_a_new_generator_file_is_found_without_an_edit(tmp_path, monkeypatch):
    """A traffic file naming a generator module that a later change adds
    is made by it: ``generators/<name>.py`` with ``make``."""
    import radiobench.generators as gens

    (tmp_path / "steady_tone.py").write_text(
        "import torch\n"
        "def make(traffic, config, seed, device):\n"
        "    n = int(traffic['samples'])\n"
        "    return {'audio': torch.full((n,), float(seed % 7)), 'n': n}\n")
    monkeypatch.setattr(gens, "__path__", [*gens.__path__, str(tmp_path)])
    x = make_inputs({"generator": "steady_tone", "samples": 5}, {}, 9, "cpu")
    assert x["n"] == 5 and x["audio"].tolist() == [2.0] * 5


def test_an_unknown_generator_is_refused():
    with pytest.raises(ValueError, match="no radiobench/generators/none_such.py"):
        make_inputs({"generator": "none_such"}, {}, SEED, "cpu")


def test_widest_gap_wraps_and_flags_a_short_output():
    want = torch.tensor([3.1, -3.1, 0.0], dtype=torch.float64)
    got = torch.tensor([-3.1, 3.1, 0.0])
    assert fm_chain.widest_gap_rad(got, want, 1.0) == pytest.approx(
        2 * math.pi - 6.2, abs=1e-6)
    assert fm_chain.widest_gap_rad(got[:2], want, 1.0) == 2 * math.pi


def test_frame_numbers_by_hand():
    sent = [b"a", b"b", b"c", b"d"]
    passes = [[b"a", b"b", b"b", b"x"], [b"a", b"b", b"c"]]
    due = [{0, 1, 2, 3}, {0, 1}]
    wrong, share, total, missed = ax25_frames.frame_numbers(passes, due, sent)
    assert (wrong, total, missed) == (2, 6, 2)  # x, one b twice; c, d missed
    assert share == pytest.approx(100 * 2 / 6)


def test_generated_frames_are_framed_by_the_reference():
    cell = small_cell("aprs1200.events")
    a = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    b = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    assert torch.equal(a["audio"], b["audio"])
    t = a["truth"]
    assert len(set(t["payloads"])) == len(t["payloads"]) == 5
    assert np.all(np.diff(t["starts"]) > 0) and t["ends"][-1] < a["n"]
    # silence between the frames, as behind a squelch
    assert float(a["audio"][: int(t["starts"][0])].abs().max()) == 0.0


def test_seeds_permute_one_set_of_frames():
    cell = small_cell("aprs1200.events")
    a = make_inputs(cell.traffic, cell.config, 1, "cpu")["truth"]
    b = make_inputs(cell.traffic, cell.config, 2, "cpu")["truth"]
    assert sorted(map(len, a["payloads"])) == sorted(map(len, b["payloads"]))
    assert a["payloads"] != b["payloads"]


def test_fm_station_planes_on_the_wire_grid():
    cell = small_cell("fm_rtl.capture")
    x = make_inputs(cell.traffic, cell.config, SEED, "cpu")
    for p in (x["i"], x["q"]):
        v = p * 128
        assert torch.equal(v, torch.round(v))
        assert float(v.min()) >= -127 and float(v.max()) <= 128


# ---- what must not load ----

def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax.numpy": 1, "jaxlib": 1, "jaxtyping": 1, "flax.linen": 1,
            "rustradio_tpu.ops": 1, "rustradio_tpu_torch.ops": 1,
            "rustradio_tpu_torch": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "rustradio_tpu.ops"]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_yardstick_imports_nothing_of_the_program():
    """The references, the generator, the trace arithmetic, the peaks and
    the metric readers import neither JAX nor the program."""
    files = [*(BENCH / "reference").glob("*.py"), *(BENCH / "metrics").glob("*.py"),
             *(BENCH / "generators").glob("*.py"), BENCH / "trace.py", BENCH / "peaks.py",
             BENCH / "harness.py"]
    for f in files:
        bad = _imports(f) & {*harness.FORBIDDEN, "rustradio_tpu_torch"}
        assert not bad, f"{f.name} imports {bad}"


def test_the_drivers_import_jax_nowhere():
    for f in [*(BENCH / "drivers").glob("*.py"), BENCH / "run.py"]:
        assert not _imports(f) & set(harness.FORBIDDEN), f.name


# ---- runs on the CPU, sound and with the timed path broken ----

@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct(name):
    res = run_cell(small_cell(name), SEED, 0.3, False, "cpu")
    assert res["correct"], [(c.name, c.value, c.limit) for c in res["compared"]]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in small_cell(name).end_to_end}


def test_the_fm_chain_with_its_resampler_is_correct():
    """The driver's and the check's resampler stage, which a cell of the
    app's whole chain names with ``"resample": true``."""
    cell = small_cell("fm_rtl.capture")
    cell.workload["driver_args"]["resample"] = True
    res = run_cell(cell, SEED, 0.3, False, "cpu")
    assert res["correct"]
    assert len(res["window"].outputs["audio"]) == -(-((1 << 15) - 1) * 3 // 64)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_on_the_cpu_reports_no_device_metric(name):
    """Without a card the trace holds no device work: the readers find
    nothing, and the line leaves the metrics out (never a 0)."""
    res = run_cell(small_cell(name), SEED, 0.3, True, "cpu")
    assert res["correct"]
    assert res["metrics"] == {}
    assert res["breakdown"]["device_ops"] == []


def test_symbol_sync_ms_per_pass_sums_the_clock_recovery_kernels():
    S = trace.Span
    tr = trace.Trace(
        device=[S("symbol_sync_events_kernel<6>", 10e6, 30e6),
                S("fir_decimate_kernel", 30e6, 40e6),
                S("symbol_sync_events_kernel<6>", 90e6, 130e6)],
        host=[], lo=0, hi=100e6)
    w = Window(seconds=0.1, samples=2, units=2, unit="pass")
    reader = harness.module("metrics", "symbol_sync_ms_per_pass")
    assert reader.read(None, w, tr) == pytest.approx((20 + 10) / 2)
    tr.device = tr.device[1:2]
    assert reader.read(None, w, tr) is None


def _fm_models(mp, alter):
    from rustradio_tpu_torch.models import fm

    real = fm.fm_demod_chain_planar
    mp.setattr(fm, "fm_demod_chain_planar", lambda *a, **k: alter(real(*a, **k)))


def _altered(y):
    """A run of outputs longer than the resampler's step, so that some
    of them reach the audio."""
    y = y.clone()
    y[len(y) // 3:len(y) // 3 + 64] += 0.01
    return y


def _half(y):
    y = y.clone()
    y[len(y) // 2:] = 0
    return y


def _hdlc_deframe(mp, alter):
    """The receiver's frames altered where the deframer makes them."""
    from rustradio_tpu_torch.models import ax25

    real = ax25.hdlc.hdlc_deframe

    def deframe(*a, **k):
        packets, state = real(*a, **k)
        return alter(list(packets)), state
    mp.setattr(ax25.hdlc, "hdlc_deframe", deframe)


def _flip_first(pkts):
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


FAULTS = {
    ("fm_rtl.capture", "answer altered"): lambda mp: _fm_models(mp, _altered),
    ("fm_rtl.capture", "half left out"): lambda mp: _fm_models(mp, _half),
    ("aprs1200.events", "answer altered"): lambda mp: _hdlc_deframe(mp, _flip_first),
    ("aprs1200.events", "half left out"):
        lambda mp: _hdlc_deframe(mp, _every_other()),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    res = run_cell(small_cell(cell), SEED, 0.3, False, "cpu")
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
