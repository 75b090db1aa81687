"""The FM receiver over a capture resident on the card, as
``apps/rtl_fm.py --rtl_u8`` runs it: one pass is
``models.fm.fm_demod_chain_planar`` (kernel B: channel filter at the
configuration's decimation and discriminator at the app's gain, on the
flat f32 planes, with ``driver_args["precision"]``) over the whole
capture and, where ``driver_args["resample"]`` is true,
``ops.resampler.rational_resampler`` to the audio rate.  The output
stays on the card."""

from __future__ import annotations

import math

from ..harness import Window
from . import passes, synchronize


def _one_pass(run):
    from rustradio_tpu_torch.models import fm
    from rustradio_tpu_torch.ops.resampler import rational_resampler

    c, prec = run.config, run.args["precision"]
    resample = bool(run.args["resample"])
    i, q = run.inputs["i"], run.inputs["q"]
    fs = float(c["samp_rate"])
    gain = fs / (2 * math.pi * float(c["deviation_hz"]))

    def one():
        demod = fm.fm_demod_chain_planar(
            i, q, fs, c["cutoff_hz"], c["twidth_hz"], deci=c["deci"],
            gain=gain, precision=prec)
        if not resample:
            return demod
        return rational_resampler(demod, int(c["audio_rate"]), int(fs))
    return one


def prepare(run) -> None:
    run.state["pass"] = _one_pass(run)
    run.state["pass"]()
    synchronize(run.device)


def window(run) -> Window:
    count, seconds, out = passes(run, run.state["pass"])
    n = run.inputs["n"]
    return Window(seconds=seconds, samples=count * n, units=count,
                  unit="pass", outputs={"audio": out, "i": run.inputs["i"],
                                        "q": run.inputs["q"]})
