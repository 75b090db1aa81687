"""The check of the wideband cells: what the receiver delivered on each
channel against what each station sent there.

The transmitter is the benchmark's (``generators/afsk_band.py``: each
station's frames made by ``afsk_frames``, framed by ``reference.hdlc``),
so the (channel, payload) of every frame sent is known from the seed.
Each pass the driver kept gives the (channel, payload) pairs the receiver
delivered.  ``ax25_frames.frame_numbers`` counts them with the pair as
the key:

- ``wrong_frames``: pairs never sent (a payload that was never sent, or a
  frame delivered on another channel than its station's), and pairs
  delivered twice in a pass.  Limit 0.
- ``missed_pct``: the frames sent and not delivered on their channel, as
  a share of the due frames over the window.  The limit is the cell's
  (``workloads/``).
"""

from __future__ import annotations

from .ax25_frames import frame_numbers


def judge(run, window) -> list:
    from ..harness import Compared

    out = window.outputs
    wrong, share, _, _ = frame_numbers(out["passes"], out["due"],
                                       run.inputs["truth"]["frames"])
    return [Compared("wrong_frames", float(wrong), run.limits["wrong_frames"]),
            Compared("missed_pct", share, run.limits["missed_pct"])]
