"""The metric readers: ``metrics/<name>.py`` reads the metric of that
name in ``BENCHMARK.json``.  A reader has ``read(run, window, trace)``
(``trace`` is the traced window's ``trace.Trace``, or None in an untraced
run) and returns the value, or None where it finds nothing to read: the
result line then leaves the metric out."""
