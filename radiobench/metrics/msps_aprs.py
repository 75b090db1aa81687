"""``msps`` of the AX.25 cells, under a name and a bound of their own:
their host tail (the deframer and its copy back) makes them spread wider
than the FM cell, whose device-bound rate ``msps`` holds to a tight
bound.  The same reading: input Msamples of all the work the window
completed, over the window's seconds (host clock)."""

from .msps import read  # noqa: F401
