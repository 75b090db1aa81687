"""The wideband receiver's demod bank on the host a pass: the host time
inside the program's ``rr::band.demod`` span (the bank's columns, the
discriminator and ``bell202_demod`` for each channel: the taps designed
and each filter enqueued), clipped to the traced window, summed and
divided by the passes.  None untraced, without passes, off the card, or
where the program opens no such span."""

from .ax25_host_tail_ms_per_pass import span_ms_per_pass

BANK = ("rr::band.demod",)


def read(run, window, trace):
    return span_ms_per_pass(window, trace, BANK)
