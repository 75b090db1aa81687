"""The program's spans: ``span(name)`` is a ``torch.profiler.record_function``
named ``rr::<name>`` while a torch profiler is recording on this thread,
and one shared null context otherwise.  The running profiler is the only
switch: untraced, a span costs one check (under a microsecond)."""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``rr::<name>`` in a running profiler's trace."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(f"rr::{name}")
