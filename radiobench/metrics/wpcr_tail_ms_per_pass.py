"""The burst receiver's host tail a pass: the host time inside the
program's ``rr::wpcr.bits`` (the slicer, the symbols' copy to the host and
each burst's NRZI), ``rr::hdlc.deframe`` (each burst's native deframer)
and ``rr::ax25.packets`` (the packet objects) spans that lie inside an
``rr::wpcr.rx`` span (a receiver call), each clipped to the traced window,
summed and divided by the passes.  None untraced, without passes, off the
card, or where the program opens no ``rr::wpcr.rx`` span."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

RX = "rr::wpcr.rx"
TAIL = ("rr::wpcr.bits", "rr::hdlc.deframe", "rr::ax25.packets")


def read(run, window, trace):
    if trace is None:
        return None
    calls = sorted((s.start, s.end) for s in trace.host if s.name == RX)
    if not calls:
        return None
    inside = [s for s in trace.host if s.name in TAIL
              and any(a <= s.start and s.end <= b for a, b in calls)]
    if not inside:
        return None
    kept = type(trace)(device=trace.device, host=inside, lo=trace.lo, hi=trace.hi)
    return span_ms_per_pass(window, kept, TAIL)
