"""The drivers: one a port entry that a window drives.  A driver module
has ``prepare(run)``, which builds what its window needs and warms every
shape up (set-up), and ``window(run) -> harness.Window``, which runs the
measured window.  ``workloads/<cell>.json`` names the driver and gives its
``driver_args``."""

from __future__ import annotations


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def passes(run, one_pass):
    """Closed-loop passes until ``run.seconds`` have passed, the next
    starting when the last is handed to the device; the window ends when
    the device has finished them all.  Returns (passes, seconds, the last
    pass's result)."""
    synchronize(run.device)
    run.mark("open")
    t0 = run.clock.now()
    count, out = 0, None
    while True:
        out = one_pass()
        count += 1
        if run.clock.now() - t0 >= run.seconds:
            break
    synchronize(run.device)
    t1 = run.clock.now()
    run.mark("close")
    return count, t1 - t0, out
