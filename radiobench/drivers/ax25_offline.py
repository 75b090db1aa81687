"""The 1200 bd AX.25 receiver over a recording resident on the card: one
pass is ``models.ax25.ax25_1200_rx(audio, samp_rate, sync=...)`` over the
whole capture, closed loop.  ``keep_checksum`` in ``driver_args`` turns
on the receiver's own path that delivers frames unverified: the
control."""

from __future__ import annotations

from ..harness import Window
from . import passes


def _one_pass(run):
    from rustradio_tpu_torch.models import ax25

    audio, fs = run.inputs["audio"], float(run.config["samp_rate"])
    kw = {k: run.args[k] for k in ("sync", "keep_checksum") if k in run.args}

    def one():
        return [bytes(p) for p in ax25.ax25_1200_rx(audio, fs, **kw)]
    return one


def prepare(run) -> None:
    run.state["pass"] = _one_pass(run)
    run.state["pass"]()


def window(run) -> Window:
    decoded: list[list[bytes]] = []
    one = run.state["pass"]

    def kept():
        decoded.append(one())

    count, seconds, _ = passes(run, kept)
    every = set(range(len(run.inputs["truth"]["payloads"])))
    return Window(seconds=seconds, samples=count * run.inputs["n"],
                  units=count, unit="pass",
                  outputs={"passes": decoded, "due": [every] * count})
