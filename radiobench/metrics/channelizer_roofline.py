"""The wideband receiver's front half against its roofline: the least
time a pass's channelizer needs, max(bytes / peak bytes/s, f32
operations / peak operations/s), over the device time the front half
took a pass in the trace.

The work is counted from the cell's shapes (``work``): the complex64
capture read once and the (frames, channels) complex64 channel matrix
written once, 16 bytes an input sample; for each input sample, the
polyphase branch filter's ``taps_per_branch`` complex-by-real
multiply-adds (4 operations each), the inverse FFT over the channels (5
log2 M a sample) and the channel power (3).

The device time is the union of the device intervals that start inside a
pass's stretch from the start of the program's ``rr::band.channelize``
span to the end of its ``rr::band.select`` span, over the stretches that
lie in the window: the select's host read of the power waits out the
channelizer, so the stretch holds the channelizer's work and nothing
else.  None untraced, off the card, or where the program opens no such
span."""

import bisect
import math

import torch

from ..peaks import card_peaks
from ..trace import union_ns

OPEN, CLOSE = "rr::band.channelize", "rr::band.select"


def work(n: int, config: dict) -> tuple[float, float]:
    """(bytes, f32 operations) of the channelizer over n input samples."""
    m, taps = int(config["n_channels"]), int(config["taps_per_branch"])
    return 16.0 * n, (4.0 * taps + 5.0 * math.log2(m) + 3.0) * n


def stretches(trace) -> list[tuple[float, float]]:
    """(start of a channelize span, end of the first select span after
    it), for each channelize span whose stretch lies in the window."""
    opens = sorted(s.start for s in trace.host if s.name == OPEN)
    closes = sorted((s.start, s.end) for s in trace.host if s.name == CLOSE)
    out = []
    for a in opens:
        j = bisect.bisect_left(closes, (a, -math.inf))
        if j < len(closes) and a >= trace.lo and closes[j][1] <= trace.hi:
            out.append((a, closes[j][1]))
    return out


def front_half_ns(trace) -> tuple[float, int]:
    """(device ns in the stretches, the number of stretches)."""
    starts = sorted((s.start, s.end) for s in trace.device)
    keys = [a for a, _ in starts]
    total, spans = 0.0, stretches(trace)
    for a, b in spans:
        inside = starts[bisect.bisect_left(keys, a):bisect.bisect_right(keys, b)]
        total += union_ns(inside, trace.lo, trace.hi)
    return total, len(spans)


def read(run, window, trace):
    if trace is None or not trace.device or window.unit != "pass" \
            or torch.device(run.device).type != "cuda":
        return None
    peaks = card_peaks(torch.cuda.get_device_name(run.device))
    ns, count = front_half_ns(trace)
    if peaks is None or count == 0 or ns <= 0:
        return None
    nbytes, flops = work(run.inputs["n"], run.config)
    least = max(nbytes / peaks[0], flops / peaks[1])
    return 100.0 * least / (ns * 1e-9 / count)
