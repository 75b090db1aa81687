"""Device time of the clock recovery a pass: the kernels whose name
holds ``symbol_sync`` (the port's kernels D and E), summed over the
traced window and divided by the passes."""

NAME = "symbol_sync"


def read(run, window, trace):
    if trace is None or window.unit != "pass" or window.units == 0:
        return None
    spans = [(s.start, s.end) for s in trace.device if NAME in s.name]
    if not spans:
        return None
    ms = sum(min(b, trace.hi) - max(a, trace.lo) for a, b in spans
             if b > trace.lo and a < trace.hi) * 1e-6
    return ms / window.units
