"""Input Msamples of all the work the window completed, over the
window's seconds (host clock)."""


def read(run, window, trace):
    if window.seconds <= 0:
        return None
    return window.samples / window.seconds / 1e6
