"""The time the AX.25 receiver's host waits on the card a pass: the host
time inside the program's ``rr::ax25.compact`` (the symbol mask's count
read) and ``rr::hdlc.to_host`` (the bits' copy to the host) spans, each
clipped to the traced window, summed and divided by the passes.  None
untraced, without passes, off the card (a trace with no device work), or
where the program opens no such span."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

WAIT = ("rr::ax25.compact", "rr::hdlc.to_host")


def read(run, window, trace):
    return span_ms_per_pass(window, trace, WAIT)
