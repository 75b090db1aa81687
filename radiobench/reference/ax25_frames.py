"""The check of the AX.25 cells: what the receiver delivered against what
the transmitter sent.

The transmitter is the benchmark's (``generators/afsk_frames.py``, framed by
``reference.hdlc``): the payloads it sent are known from the seed.  Each
pass the cell's driver module kept gives the payloads the receiver delivered and the
frames that were due (every frame, for a pass over the whole capture).
Two numbers:

- ``wrong_frames``: delivered payloads that were never sent, and
  payloads delivered twice in a pass.  Limit 0: a receiver that passes
  its frame check delivers what was sent, once.
- ``missed_pct``: the due frames not delivered, as a share of the due
  frames over the window.  The limit is the cell's (``workloads/``).
"""

from __future__ import annotations

import collections


def frame_numbers(passes, due, payloads) -> tuple[int, float, int, int]:
    """(wrong frames, missed share in %, due frames, missed frames)."""
    index = {p: f for f, p in enumerate(payloads)}
    wrong = missed = total = 0
    for got, want in zip(passes, due):
        counts = collections.Counter(got)
        wrong += sum(c for p, c in counts.items() if p not in index)
        wrong += sum(c - 1 for p, c in counts.items() if p in index and c > 1)
        found = {index[p] for p in counts if p in index}
        missed += len(set(want) - found)
        total += len(want)
    share = 100.0 * missed / total if total else 100.0
    return wrong, share, total, missed


def judge(run, window) -> list:
    from ..harness import Compared

    out = window.outputs
    wrong, share, _, _ = frame_numbers(out["passes"], out["due"],
                                       run.inputs["truth"]["payloads"])
    return [Compared("wrong_frames", float(wrong), run.limits["wrong_frames"]),
            Compared("missed_pct", share, run.limits["missed_pct"])]
