"""chip_smoke.py's phase 9 rehearsed on the CPU with the wideband receiver
on both clock recoveries: kernel E's plain version, a Python loop over a
channel's samples, costs ~0.6 s a call on a 32 kHz channel here, and the
phase calls it some twenty times.  The Tier-1 rehearsal
(``tests/test_torch_chip_smoke.py``) drives the events sync alone."""

import pytest

from test_torch_chip_smoke import rehearse_sync_phase


@pytest.mark.slow
def test_torch_chip_smoke_sync_phase_both_syncs_rehearse_on_the_cpu(monkeypatch,
                                                                    capsys):
    cs, (errs, _, _, wb_counts), out = rehearse_sync_phase(
        monkeypatch, capsys, ("scan", "events"), (3, 38))
    assert errs == {"symbol_sync_events": 0.0, "symbol_sync_scan": 0.0,
                    "pfb_channelize": 0.0}
    assert set(wb_counts) == {"scan", "events"}
    assert out.count("2/2 frames on their channels") == 2
    assert "[9 sync] wideband scan: kernel E" in out
