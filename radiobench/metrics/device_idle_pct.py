"""100 * (1 - the union of the device's kernel, copy and fill intervals
over the traced window's span)."""


def read(run, window, trace):
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
