"""The check of the burst receiver's cell: what the receiver delivered
against what the transmitter sent, and against what the float64
reference receiver (``reference.wpcr_rx``) delivers from the same
capture.

The transmitter is the benchmark's (``generators/afsk_iq_bursts.py``: the
frames of ``afsk_frames``, framed by ``reference.hdlc``), so the payloads
sent are known from the seed.  Each pass the driver kept gives the
payloads the receiver delivered.  Three numbers:

- ``wrong_frames``: delivered payloads never sent, and payloads delivered
  twice in a pass (``ax25_frames.frame_numbers``).  Limit 0.
- ``missed_pct``: the frames sent and not delivered, as a share of the
  due frames over the window.
- ``ref_gap_pct``: over the window's passes, the frames that exactly one
  of the program and the reference delivers, as a share of the frames
  sent.  The reference runs once, on the timed capture itself, with the
  configuration's parameters.

The limits are the cell's (``workloads/``).
"""

from __future__ import annotations

from . import wpcr_rx
from .ax25_frames import frame_numbers


def reference_frames(iq, config: dict) -> set[bytes]:
    """The payloads the reference receiver delivers from ``iq``."""
    got = wpcr_rx.receive(iq, float(config["samp_rate"]),
                          float(config["new_rate"]), float(config["iir_alpha"]),
                          float(config["threshold"]), int(config["tail"]))
    return set(got["frames"])


def gap_share(passes, reference: set, sent: int) -> float:
    """100 x the frames delivered by exactly one of each pass and the
    reference, over the frames sent in all the passes."""
    total = sent * len(passes)
    gap = sum(len(set(got) ^ reference) for got in passes)
    return 100.0 * gap / total if total else 100.0


def judge(run, window) -> list:
    from ..harness import Compared

    out = window.outputs
    payloads = run.inputs["truth"]["payloads"]
    wrong, share, _, _ = frame_numbers(out["passes"], out["due"], payloads)
    ref = reference_frames(run.inputs["iq"], run.config)
    gap = gap_share(out["passes"], ref, len(payloads))
    return [Compared("wrong_frames", float(wrong), run.limits["wrong_frames"]),
            Compared("missed_pct", share, run.limits["missed_pct"]),
            Compared("ref_gap_pct", gap, run.limits["ref_gap_pct"])]
