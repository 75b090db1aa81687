"""The wideband receiver's host tail a pass: the host time inside the
program's ``rr::band.bits`` (each channel's slicer and NRZI),
``rr::hdlc.deframe`` (each channel's native deframer) and
``rr::band.packets`` (the decoded channels' objects) spans, each clipped
to the traced window, summed and divided by the passes.  None untraced,
without passes, off the card, or where the program opens no
``rr::band.bits`` span (a program whose wideband receiver has no spans
of its own still opens the deframer's)."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

TAIL = ("rr::band.bits", "rr::hdlc.deframe", "rr::band.packets")


def read(run, window, trace):
    if trace is None or not any(s.name == TAIL[0] for s in trace.host):
        return None
    return span_ms_per_pass(window, trace, TAIL)
