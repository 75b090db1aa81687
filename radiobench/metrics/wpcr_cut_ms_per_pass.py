"""The burst receiver's cut a pass: the host time inside the program's
``rr::wpcr.cut`` span (the gate's edges, their positions read on the host,
which waits out the front-end, and the bursts' cuts), clipped to the
traced window, summed and divided by the passes.  None untraced, without
passes, off the card, or where the program opens no such span."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

CUT = ("rr::wpcr.cut",)


def read(run, window, trace):
    return span_ms_per_pass(window, trace, CUT)
