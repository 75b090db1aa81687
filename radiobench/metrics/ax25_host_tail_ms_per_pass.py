"""The AX.25 receiver's host tail a pass: the host time inside the
program's ``rr::hdlc.deframe`` and ``rr::ax25.packets`` spans (the native
deframer and the packet objects, after the pass's last device result has
arrived, while the card has nothing queued), each clipped to the traced
window, summed and divided by the passes.  None untraced, without passes,
off the card (a trace with no device work), or where the program opens no
such span."""

TAIL = ("rr::hdlc.deframe", "rr::ax25.packets")


def span_ms_per_pass(window, trace, names) -> float | None:
    """Milliseconds a pass inside the window thread's host spans named
    ``names``, each clipped to [``trace.lo``, ``trace.hi``]."""
    if trace is None or not trace.device or window.unit != "pass" \
            or window.units == 0:
        return None
    spans = [s for s in trace.host if s.name in names]
    if not spans:
        return None
    ns = sum(max(0.0, min(s.end, trace.hi) - max(s.start, trace.lo))
             for s in spans)
    return ns * 1e-6 / window.units


def read(run, window, trace):
    return span_ms_per_pass(window, trace, TAIL)
