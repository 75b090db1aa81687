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
