"""Wideband multichannel AX.25 decoding, the channel-parallel receiver
(port of ``rustradio_tpu/models/multichannel.py``).

One wideband capture is polyphase-channelized (``parallel.channelizer``),
the active channels go through the FM + Bell-202 demod bank, and the clock
recovery of all of them advances in one kernel launch, one thread per
channel (kernel E for ``method="scan"``, kernel D for ``"events"``).  Only
the emitted symbols leave the device; the HDLC byte assembly runs on the
host (native C++).

Under a running torch profiler ``decode_band_ax25`` opens the spans
``rr::band.rx`` (the call) and, once a call each inside it,
``rr::band.channelize``, ``.select``, ``.demod``, ``.clock``,
``.compact``, ``.bits`` and ``.packets`` (``utils.trace.span``); ``TOTALS``
counts its calls, the channels of its banks, the channels the events path
re-ran and the packets it delivered.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import hdlc, nrzi
from ..ops.elementwise import binary_slicer
from ..ops.symbol_sync import compact, symbol_sync, symbol_sync_events
from ..parallel.channelizer import channelizer_taps, pfb_channelize_power
from ..utils.trace import span
from .ax25 import Ax25Packet, bell202_demod

METHODS = ("scan", "events")

#: over every ``decode_band_ax25`` call of the process, each added once a
#: call: the calls, the channels of their demod banks, the channels the
#: events path re-ran on the exact scan, and the packets delivered.  Read as
#: differences around a call, as ``apps/scanner.py --decode``'s closing
#: line does
TOTALS = {"calls": 0, "active": 0, "rerun": 0, "packets": 0}


def recover_symbols_batch(xs, sps: float, max_deviation: float = 0.5,
                          clock_taps=(0.5, 0.5), unroll: int = 16,
                          method: str = "scan", max_events: int | None = None,
                          return_valid: bool = False, device=None):
    """Clock recovery over a (C, N) batch of NRZ streams in one launch.

    Returns ``(values, mask, clocks)``, each (C, N).  ``method="scan"`` is
    the per-sample recurrence (bit-exact with native ``rr_symbol_sync``);
    ``"events"`` the event-driven form (decode-equivalent, see
    ``ops.symbol_sync.symbol_sync_events``), whose channels with more than
    ``max_events`` crossings are untrustworthy: ``return_valid=True`` adds
    the per-channel flags as a 4th output (all True for the scan).
    ``unroll`` is accepted for the JAX signature and changes nothing.  A
    numpy input needs ``device=``.
    """
    if method == "events":
        (vals, mask, clks), valid = symbol_sync_events(
            xs, sps, max_deviation, clock_taps, max_events=max_events,
            unroll=unroll, device=device)
    elif method == "scan":
        (vals, mask, clks), _ = symbol_sync(xs, sps, max_deviation, clock_taps,
                                            unroll=unroll, device=device)
        valid = torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
    else:
        raise ValueError(f"unknown method {method!r}; use 'scan' or 'events'")
    if return_valid:
        return vals, mask, clks, valid
    return vals, mask, clks


def _discriminator(channels: torch.Tensor) -> torch.Tensor:
    """(C, N) complex channel streams -> (C, N - 1) f32: the exact FM
    discriminator, atan2 of conj(y[n]) * y[n + 1]."""
    d = torch.conj(channels[:, :-1]) * channels[:, 1:]
    return torch.atan2(d.imag, d.real)


def _afsk_bank(channels: torch.Tensor, chan_rate: float) -> torch.Tensor:
    """(C, N) complex channel streams -> (C, N - 2) Bell-202 NRZ floats:
    the discriminator per channel, then ``bell202_demod`` (kernel A on the
    card) channel by channel."""
    return torch.stack([bell202_demod(a, chan_rate)
                        for a in _discriminator(channels)])


def _bank_demod(ch: torch.Tensor, idx, rate: float) -> torch.Tensor:
    """Channel selection + demod bank: columns ``idx`` of the channelizer
    output ``ch`` (frames, M)."""
    cols = torch.as_tensor(idx, dtype=torch.int64, device=ch.device)
    return _afsk_bank(ch[:, cols].T.contiguous(), rate)


@dataclasses.dataclass
class ChannelDecode:
    channel: int
    freq: float  # channel center relative to capture center, Hz
    packets: list


def decode_band_ax25(
    iq,
    samp_rate: float,
    n_channels: int = 64,
    baud: float = 1200.0,
    max_active: int = 8,
    power_floor_db: float = -40.0,
    fix_bits: bool = False,
    sync_method: str = "scan",
    symbol_taps=(1 / 6,) * 6,
    symbol_max_deviation: float = 0.5,
    device=None,
) -> list[ChannelDecode]:
    """Channelize a wideband capture and decode AX.25 on every active
    channel concurrently.

    ``max_active`` bounds the decode bank; channels are picked by power
    above ``power_floor_db`` relative to the strongest.  The per-channel
    rate samp_rate/n_channels must give > 2 samples per symbol at
    ``baud``.  ``sync_method="events"`` uses the event-driven clock
    recovery (a channel that overflows its crossing budget is re-run on
    the exact scan); ``"scan"`` is the bit-exact recurrence.  Both take
    ``symbol_taps`` and ``symbol_max_deviation``, whose defaults are
    ``models.ax25.ax25_1200_rx``'s, since the bank runs that receiver's
    demod chain; the JAX package's bank keeps ``recover_symbols_batch``'s
    (0.5, 0.5), which at 16.7 samples a symbol slips on some frames sent
    1.5% fast (ROADMAP queue 3, item 16).  ``iq`` is a complex tensor (it
    stays on its device) or numpy with ``device=``.
    """
    if sync_method not in METHODS:
        raise ValueError(f"unknown method {sync_method!r}; use 'scan' or "
                         f"'events'")
    M = int(n_channels)
    fs = float(samp_rate)
    chan_rate = fs / M
    sps = chan_rate / float(baud)
    if sps <= 2.0:
        raise ValueError(
            f"{chan_rate:.0f} Hz per channel gives only {sps:.1f} samples/"
            f"symbol at {baud:.0f} bd; use fewer channels"
        )

    with span("band.rx"):
        clock = (sps, float(symbol_max_deviation), tuple(symbol_taps))
        out, rerun = _decode(iq, fs, M, clock, max_active, power_floor_db,
                             fix_bits, sync_method, device)
    TOTALS["calls"] += 1
    TOTALS["active"] += len(out)
    TOTALS["rerun"] += rerun
    TOTALS["packets"] += sum(len(r.packets) for r in out)
    return [r for r in out if r.packets]


def _decode(iq, fs: float, M: int, clock: tuple, max_active: int,
            power_floor_db: float, fix_bits: bool, sync_method: str, device):
    """The body of :func:`decode_band_ax25`, with ``clock`` = (samples a
    symbol, deviation, filter taps): every channel of the bank as a
    ``ChannelDecode``, those without packets too, and the count of
    channels re-run on the exact scan."""
    with span("band.channelize"):
        ch, power = pfb_channelize_power(iq, channelizer_taps(M, 8), M,
                                         device=device)
    # the power's copy to the host is the pass's first wait: it waits out
    # the channelizer
    with span("band.select"):
        power = power.cpu().numpy()
        order = np.argsort(power)[::-1]
        floor = power[order[0]] * 10.0 ** (power_floor_db / 10.0)
        active = [int(k) for k in order[:max_active] if power[k] > floor]
    if not active:
        return [], 0

    with span("band.demod"):
        nrz = _bank_demod(ch, active, fs / M)
    del ch
    rerun = 0
    with span("band.clock"):
        if sync_method == "events":
            # budget ~4x the expected crossing count, pow-2 bucketed, never
            # below 1024 (multichannel.py:165-169)
            want = max(1024, int(4 * nrz.shape[1] / clock[0]))
            budget = 1 << (want - 1).bit_length()
            vals, mask, _, valid = recover_symbols_batch(
                nrz, *clock, method="events", max_events=budget,
                return_valid=True)
            bad = torch.nonzero(~valid).flatten()
            rerun = bad.numel()
            if rerun:
                # chatter beyond the budget: those channels re-run bit-exact
                _, ms, _ = recover_symbols_batch(nrz[bad], *clock)
                mask[bad] = ms
        else:
            vals, mask, _ = recover_symbols_batch(nrz, *clock)

    # the first count read waits out the clock recovery
    with span("band.compact"):
        symbols = [compact(vals[row], mask[row]) for row in range(len(active))]
    with span("band.bits"):
        bits = [nrzi.nrzi_decode(binary_slicer(s)) for s in symbols]
    frames = [hdlc.hdlc_deframe(b, 10, 1500, fix_bits=fix_bits)[0] for b in bits]
    with span("band.packets"):
        return [ChannelDecode(
            channel=k, freq=(k if k < M / 2 else k - M) * fs / M,
            packets=[Ax25Packet(np.asarray(d), int(p)) for d, p in pkts])
            for k, pkts in zip(active, frames)], rerun
