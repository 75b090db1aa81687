"""The burst receiver's clock recovery a pass: the host time inside the
program's ``rr::wpcr.clock`` span (``wpcr_batch``: the bursts padded into
each power-of-two bucket, each bucket's midpoint, chirp-Z DFT, best bin
and emission mask, and its table read, which waits the bucket out),
clipped to the traced window, summed and divided by the passes.  None
untraced, without passes, off the card, or where the program opens no such
span."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

CLOCK = ("rr::wpcr.clock",)


def read(run, window, trace):
    return span_ms_per_pass(window, trace, CLOCK)
