"""A rehearsal of ``chip_smoke.py``'s phase 12 (the radio-facing receivers)
on the CPU at small sizes: every step of the phase (the apps on files, the
simulated SDR, the IL2P capture and blocks, the checks against the model
calls and the plain versions) runs on the kernels' plain versions, so a
broken step shows here before a chip run is spent on it.  The launch
requirements need the card and are left out (no kernel launches here).
"""

import importlib.util
import sys
from pathlib import Path

import torch
# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process, ~2 s once: imported with this module, so that
# each test's time is its own.
import torch._dynamo  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)  # for its dataclass
    spec.loader.exec_module(mod)
    return mod


def test_torch_chip_smoke_radio_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.RadioSizes(frames=2, frame_gate=2, iq_frames=1, iq_gate=1,
                          bell_lines=2, il2p_frames=2, il2p_chunk=300, il2p_gap=200,
                          sim_samples=1 << 15, scan_samples=1 << 15, reps=1)
    counts, errs = cs.radio_phase(torch.device("cpu"), "cpu rehearsal", sizes,
                                  cs.audio_corpus(hdlc, sizes.frames),
                                  cs.iq_capture(hdlc, sizes.iq_frames))
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("12 ax25 au", "12 ax25 iq and bell202", "12 il2p", "12 sdr"):
        assert f"[{phase}] passed" in out
    # the plain versions on both sides of every hold
    assert errs == {"fir_decimate": 0.0, "symbol_sync_events": 0.0,
                    "symbol_sync_scan": 0.0}
    assert set(counts) >= {"ax25_1200_rx au native", "ax25_1200_rx au events",
                           "ax25_1200_rx c32", "ax25_1200_rx SigMF", "bell202_tx",
                           "il2p_1200_rx", "il2p_1200_rx app", "rtl_fm sim",
                           "soapy_fm sim", "scanner sim", "scanner sim decode"}


def test_torch_chip_smoke_scan_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 13 at small sizes, the CUDA-graph capture stood in for (each
    # replay runs the recorded function), so that its capture bookkeeping
    # runs here too; the checks of launches and replays need the card
    import rustradio_tpu_torch.graph as graph_mod
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    class Record:
        counts: dict = {}

    class Replayed:
        def __init__(self, fn):
            self.fn, self.record = fn, Record()

        def replay(self):
            return self.fn()

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    monkeypatch.setattr(graph_mod, "_can_capture", lambda device: True)
    monkeypatch.setattr(graph_mod, "_warm_up", lambda device, fn: (fn(), Record()))
    monkeypatch.setattr(graph_mod, "_capture", lambda device, fn: Replayed(fn))
    sizes = cs.ScanSizes(chunk=4096, chunks=9, scans=(9, 4), reps=1,
                         ax_chunk=1 << 14, ax_scan=4, frames=2, frame_gate=2,
                         block_chunk=1024, tone_n=1 << 14, fm_seconds=0.25,
                         app_reps=1)
    cpu = torch.device("cpu")
    audio = cs.audio_corpus(hdlc, sizes.frames)
    want = {s: cs.decoded(ax25.ax25_1200_rx_graph(audio, cs.FS_AUDIO,
                                                  chunk_size=sizes.ax_chunk,
                                                  sync=s, device="cpu"), sizes.frames)
            for s in ("native", "events")}
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs = cs.scan_phase(cpu, "cpu rehearsal", sizes, i_main, q_main,
                                 audio, want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("13 fm stream", "13 ax25 graph", "13 blocks", "13 generators"):
        assert f"[{phase}] passed" in out
    assert "the trace held no device events" in out and "GFLOP" in out
    assert errs == {"fm_chain": 0.0, "fir_decimate": 0.0,
                    "symbol_sync_events": 0.0}
    assert {"tone", "fm_tx", "spectrum", "morse_beacon", "pw_tone",
            "fm chain device scan_chunks=4"} <= set(counts)
