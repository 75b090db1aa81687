"""The readers of the program's spans, ``ax25_host_tail_ms_per_pass`` and
``ax25_host_wait_ms_per_pass``, on hand-built traces: each span clipped
to the window, other names left out, the sum exact; nothing read
untraced, without passes, off the card or where no such span is open."""

import pytest

from radiobench import harness, trace
from radiobench.harness import Window

S = trace.Span
READERS = {
    "ax25_host_tail_ms_per_pass": ("rr::hdlc.deframe", "rr::ax25.packets"),
    "ax25_host_wait_ms_per_pass": ("rr::ax25.compact", "rr::hdlc.to_host"),
}
LO, HI = 1_000_000.0, 41_000_000.0  # ns: a 40 ms window


def _trace(a, b):
    """Spans of the reader's names ``a`` and ``b`` (ms in the window's
    own time, 0 at ``LO``), the other reader's and the pass's own."""
    other = next(n for r in READERS.values() if (a, b) != r for n in r)
    ms = 1e6
    host = [S("rr::ax25.rx", LO - 2 * ms, HI + ms),
            S(a, LO - 1.5 * ms, LO + 0.25 * ms),   # straddles lo: 0.25
            S(b, LO + 3 * ms, LO + 4.125 * ms),    # 1.125
            S(other, LO + 5 * ms, LO + 9 * ms),    # another reader's
            S(a, LO + 20 * ms, LO + 20.5 * ms),    # 0.5
            S("aten::copy_", LO + 21 * ms, LO + 22 * ms),
            S(b, HI - 0.0625 * ms, HI + 3 * ms)]   # straddles hi: 0.0625
    device = [S("symbol_sync_events_kernel<6>", LO + ms, LO + 18 * ms)]
    return trace.Trace(device=device, host=host, lo=LO, hi=HI)


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers_clip_sum_and_divide(name):
    reader = harness.module("metrics", name)
    tr = _trace(*READERS[name])
    w = Window(seconds=0.04, samples=2, units=2, unit="pass")
    assert abs(reader.read(None, w, tr) - (0.25 + 1.125 + 0.5 + 0.0625) / 2) < 1e-9
    w1 = Window(seconds=0.04, samples=1, units=1, unit="pass")
    assert abs(reader.read(None, w1, tr) - 1.9375) < 1e-9


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers_find_nothing_to_read(name):
    reader = harness.module("metrics", name)
    tr = _trace(*READERS[name])
    assert reader.read(None, Window(1.0, 2, 2, "pass"), None) is None
    assert reader.read(None, Window(1.0, 0, 0, "pass"), tr) is None
    assert reader.read(None, Window(1.0, 2, 2, "chunk"), tr) is None
    # the parent program opens no such span
    bare = trace.Trace(device=tr.device, host=[s for s in tr.host
                                               if s.name not in READERS[name]],
                       lo=LO, hi=HI)
    assert reader.read(None, Window(1.0, 2, 2, "pass"), bare) is None
    # a run off the card: the trace holds no device work
    tr.device = []
    assert reader.read(None, Window(1.0, 2, 2, "pass"), tr) is None
