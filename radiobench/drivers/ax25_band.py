"""The wideband 2 m receiver over a capture resident on the card, as
``apps/scanner.py --decode`` runs it: one pass is
``models.multichannel.decode_band_ax25(iq, samp_rate, n_channels=...,
max_active=..., sync_method=..., symbol_taps=...,
symbol_max_deviation=...)`` over the whole capture, with the
configuration's channels, bank and clock recovery, closed loop.  A pass
keeps every delivered frame as (channel, payload).  A program whose
receiver takes no clock filter cannot run the configuration: its first
pass, in set-up, raises.

``swap_neighbour_labels`` in ``driver_args`` hands each frame on with its
channel's label swapped for its neighbour's (channel 2j for 2j + 1 and
back): the control, which breaks the guarantee that a frame is delivered
on its station's channel."""

from __future__ import annotations

from ..harness import Window
from . import passes


def _one_pass(run):
    from rustradio_tpu_torch.models import multichannel

    c, iq = run.config, run.inputs["iq"]
    flip = 1 if run.args.get("swap_neighbour_labels") else 0

    def one():
        res = multichannel.decode_band_ax25(
            iq, float(c["samp_rate"]), n_channels=int(c["n_channels"]),
            baud=float(c["baud"]), max_active=int(c["max_active"]),
            sync_method=c["sync"], symbol_taps=tuple(c["symbol_taps"]),
            symbol_max_deviation=float(c["symbol_max_deviation"]))
        return [(r.channel ^ flip, bytes(p)) for r in res for p in r.packets]
    return one


def prepare(run) -> None:
    run.state["pass"] = _one_pass(run)
    run.state["pass"]()


def window(run) -> Window:
    decoded: list[list[tuple[int, bytes]]] = []
    one = run.state["pass"]

    def kept():
        decoded.append(one())

    count, seconds, _ = passes(run, kept)
    every = set(range(len(run.inputs["truth"]["frames"])))
    return Window(seconds=seconds, samples=count * run.inputs["n"],
                  units=count, unit="pass",
                  outputs={"passes": decoded, "due": [every] * count})
