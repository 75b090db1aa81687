"""The FM chain's share of its roofline: the least time a pass needs,
max(bytes / peak bytes/s, f32 operations / peak operations/s), over the
device time a pass took in the trace (the union of the device's
intervals in the window, over the passes).

The work is the least that any implementation of the configuration's
chain must do, counted from the cell's shapes: the f32 I and Q planes
read once (8 bytes a sample) and the f32 audio written once; for each
audio sample, the two filtered samples its discriminator output needs on
each plane (the filter's multiply-adds, 2 operations each; every
filtered sample at most once) and the discriminator's conjugate product
(6) and one arctangent (counted as 1, the least).  Where the cell
resamples, the resampler keeps one discriminator output in ``samp_rate /
audio_rate``, so the filtered samples that no audio sample needs are not
counted; else every discriminator output is the cell's output."""

import torch

from ..peaks import card_peaks
from ..reference.fm_chain import resample_ratio
from ..reference.taps import ntaps


def work(n: int, config: dict, resample: bool) -> tuple[float, float]:
    """(bytes, f32 operations) of the chain over n input samples."""
    filtered = -(-n // int(config["deci"]))
    audio = filtered - 1
    if resample:
        interp, down = resample_ratio(config)
        audio = -(-audio * interp // down)
    taps = ntaps(config["samp_rate"], config["twidth_hz"])
    nbytes = 8.0 * n + 4.0 * audio
    flops = 2.0 * 2.0 * taps * min(2 * audio, filtered) + 7.0 * audio
    return nbytes, flops


def read(run, window, trace):
    if trace is None or not trace.device or window.unit != "pass" \
            or window.units == 0 or torch.device(run.device).type != "cuda":
        return None
    peaks = card_peaks(torch.cuda.get_device_name(run.device))
    if peaks is None:
        return None
    nbytes, flops = work(run.inputs["n"], run.config, bool(run.args["resample"]))
    least = max(nbytes / peaks[0], flops / peaks[1])
    per_pass = trace.busy_s() / window.units
    return 100.0 * least / per_pass
