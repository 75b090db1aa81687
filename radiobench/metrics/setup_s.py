"""Set-up: from the run's start (before torch is imported) to the
window's opening: loading, building, making the inputs, warming up."""


def read(run, window, trace):
    return run.setup_s
