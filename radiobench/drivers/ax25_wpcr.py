"""The 1200 bd AX.25 burst receiver over a capture resident on the card,
as ``apps/ax25_1200_wpcr.py`` runs it: one pass is
``models.ax25.ax25_1200_wpcr_rx(iq, samp_rate, new_rate=..., iir_alpha=...,
threshold=..., tail=...)`` over the whole capture at the configuration's
values (the app's defaults), closed loop.  A pass keeps every delivered
payload.  The window also keeps what the program's burst counter
(``ops.wpcr.TOTALS``, where the program has one) counted over it."""

from __future__ import annotations

from ..harness import Window
from . import passes


def _one_pass(run):
    from rustradio_tpu_torch.models import ax25

    c, iq = run.config, run.inputs["iq"]

    def one():
        return [bytes(p) for p in ax25.ax25_1200_wpcr_rx(
            iq, float(c["samp_rate"]), new_rate=float(c["new_rate"]),
            iir_alpha=float(c["iir_alpha"]), threshold=float(c["threshold"]),
            tail=int(c["tail"]))]
    return one


def _totals() -> dict | None:
    """The program's burst counter, or None where it has none."""
    import importlib

    wpcr = importlib.import_module("rustradio_tpu_torch.ops.wpcr")
    totals = getattr(wpcr, "TOTALS", None)
    return None if totals is None else dict(totals)


def prepare(run) -> None:
    run.state["pass"] = _one_pass(run)
    run.state["pass"]()


def window(run) -> Window:
    decoded: list[list[bytes]] = []
    one = run.state["pass"]

    def kept():
        decoded.append(one())

    before = _totals()
    count, seconds, _ = passes(run, kept)
    after = _totals()
    counted = None if before is None else {k: after[k] - before.get(k, 0)
                                           for k in after}
    every = set(range(len(run.inputs["truth"]["payloads"])))
    return Window(seconds=seconds, samples=count * run.inputs["n"],
                  units=count, unit="pass",
                  outputs={"passes": decoded, "due": [every] * count,
                           "wpcr_totals": counted})
