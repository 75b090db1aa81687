"""Edge inputs of the clock recovery (kernels D and E), numpy from a seed.

One list of cases serves the CPU parity tests (the plain versions against
the JAX package), the card tests and ``chip_smoke.py`` (the kernels against
the plain versions): sizes around one tile of the kernels (1024 samples or
slots) and around the two tiles a block keeps in flight, rows that start
off the 16-byte grid (odd lengths, channels past the first), silence over
several tiles, a crossing on every sample, crossings on a tile's first and
last sample, 2.5 to 100 samples per symbol, 1 to 16 clock taps, and streams
cut at arbitrary positions and chained through the carried state, and
streams entered from a state whose position is far from zero (around 2^16
and 2^17, where an f32 position's last place is worth 2^-7 and 2^-6 of a
sample).

:func:`run_case` runs one case through every entry point on a device and
returns the outputs by name, so two runs (card and CPU, or port and
reference) compare key by key.
"""

from __future__ import annotations

import importlib
import typing

import numpy as np
import torch

from ..ops import kernels

# the module (the package exports a function of the same name)
tss = importlib.import_module("..ops.symbol_sync", __package__)

TILE = 1024  # samples (kernel E) or slots (kernel D) per tile, csrc/sync_core.cuh


class SyncCase(typing.NamedTuple):
    name: str
    x: np.ndarray             # (C, N) float32
    sps: float
    max_deviation: float
    taps: tuple
    cuts: tuple               # where a chained run cuts the stream
    max_events: int | None    # slot budget of the event form (None: default)
    state0: dict | None = None  # the per-sample form starts here (None: fresh)


def nrz(rng, c: int, n: int, sps: float, sigma: float) -> np.ndarray:
    """Random bits held for sps samples (fractional rates included), plus
    Gaussian noise: (c, n) float32."""
    nbits = int(n / sps) + 2
    bits = rng.randint(0, 2, (c, nbits)) * 2.0 - 1.0
    at = np.minimum((np.arange(n) / sps).astype(int), nbits - 1)
    x = bits[:, at].astype(np.float32)
    return x + rng.randn(c, n).astype(np.float32) * sigma


def cases(seed: int = 0) -> list[SyncCase]:
    rng = np.random.RandomState(seed)
    two, six = (0.5, 0.5), (1 / 6,) * 6
    out = []

    def add(name, x, sps, taps=two, cuts=(), max_events=None, dev=0.5):
        out.append(SyncCase(name, np.ascontiguousarray(x, np.float32), sps, dev,
                            tuple(taps), tuple(cuts), max_events))

    # sizes: nothing, one sample, around one tile, around the two in flight
    add("n0", np.zeros((2, 0)), 10.0)
    add("n1", np.array([[0.4], [-0.4], [0.0]]), 10.0)
    for n in (TILE - 1, TILE, TILE + 1, 2 * TILE - 1, 2 * TILE, 2 * TILE + 1,
              3 * TILE + 1):
        add(f"n{n}", nrz(rng, 3, n, 10.0, 0.3), 10.0, cuts=(n // 3,))
    # silence: no crossing for three tiles, the position far past 10 clocks,
    # then a first interval of thousands of samples
    x = nrz(rng, 3, 4 * TILE + 200, 8.0, 0.1)
    x[0, 300:300 + 3 * TILE + 77] = 0.7
    x[1, 5:] = -0.7
    x[2, :] = 0.7
    add("silence", x, 8.0, cuts=(TILE + 1, 3 * TILE))
    # chatter: a crossing on every sample (applied at sps 2.5, where an
    # interval of 2 is in range; out of range at sps 10), and white noise
    alt = np.where(np.arange(2 * TILE + 5) % 2 == 0, 0.5, -0.5)
    x = np.stack([alt, -alt, rng.randn(alt.size)])
    add("chatter_sps2.5", x, 2.5, cuts=(TILE,), max_events=alt.size)
    add("chatter_sps10", x, 10.0, cuts=(777,), max_events=alt.size)
    # the event form's slot counts around a tile, real slots filling or
    # overflowing them (white noise crosses on half its samples)
    x = rng.randn(3, 4 * TILE + 3)
    x[1, 2 * TILE:] = 1.0   # half the crossings
    x[2, 40:] = -1.0        # a handful
    for slots in (1, TILE - 1, TILE, TILE + 1, 2 * TILE, 2 * TILE + 1):
        add(f"slots{slots}", x, 4.0, max_events=slots)
    # a crossing on the first and on the last sample of a tile: NRZ at 8
    # samples a symbol turns at multiples of 8 (1024, 2048), one sample
    # earlier on channel 1 (1023, 2047); channel 2 crosses at sample 0
    bits = np.where(np.arange(3 * TILE // 8 + 2) % 2 == 0, -1.0, 1.0)
    base = np.repeat(bits, 8)[:2 * TILE + 40]
    add("tile_edges", np.stack([base, np.roll(base, -1), -base]), 8.0,
        cuts=(TILE - 1, TILE))
    # samples per symbol
    for sps in (2.5, 26.667, 36.75, 100.0):
        add(f"sps{sps}", nrz(rng, 3, TILE + 500, sps, 0.2), sps,
            cuts=(333, TILE + 1))
    # clock filter taps: the compiled counts (1, 2, 6) and the general form
    for taps in ((0.7,), (0.25, 0.75), (0.4, 0.3, 0.3), six, (1 / 16,) * 16):
        add(f"taps{len(taps)}", nrz(rng, 3, TILE + 300, 12.6, 0.25), 12.6,
            taps=taps, cuts=(501,))
    # cuts at arbitrary positions, the first after one sample
    add("cuts", nrz(rng, 3, 2 * TILE + 100, 10.0, 0.3), 10.0, taps=six,
        cuts=(1, 700, TILE, 1555))
    # the per-sample form entered after a long silence: no crossing since
    # position 3.7, so nothing stepped back and the position ran on, to
    # just under 2^17 (channel 0 passes it mid-run, channel 3 within three
    # samples), past it (channel 1), and through 2^16 (channel 2).  The
    # first crossing then measures an interval of a thousand symbols,
    # catches the middle up over as many, and the position steps back by
    # 10 clocks a sample for a hundred samples
    pos = np.array([131072 - 300.375, 131072 + 5.5, 65536 - 100.625,
                    131072 - 2.25], np.float32)
    out.append(SyncCase(
        "far_position", nrz(rng, 4, 900, 100.0, 0.1).astype(np.float32), 100.0,
        0.5, two, (450,), None, dict(
            clock=np.full(4, 100.0, np.float32), last_sign=np.zeros(4, bool),
            stream_pos=pos, last_sym_boundary_pos=np.full(4, 3.7, np.float32),
            next_sym_middle=pos + np.float32(3.125),
            fbuf=np.full((4, 1), 100.0, np.float32))))
    return out


def fresh_event_args(x: torch.Tensor, case: SyncCase, max_events: int):
    """Kernel D's arguments for ``x`` (C, N) from the fresh state: the
    crossing slots and the states."""
    c, n = x.shape
    k = kernels.sync_consts(case.sps, case.max_deviation, case.taps)
    sign = x > 0.0
    changed = torch.cat([sign[:, :1], sign[:, 1:] != sign[:, :-1]], 1)
    events = tss._crossings(changed, max_events)
    mid0 = float(np.float32(k.sps) / np.float32(2.0) + np.float32(1.0))
    fstate = torch.tensor([k.sps, mid0, 1.0] + [k.sps] * k.nf,
                          device=x.device).expand(c, -1).contiguous()
    istate = torch.tensor([-1, 0, 0], dtype=torch.int32,
                          device=x.device).expand(c, -1).contiguous()
    return (events, n, case.sps, case.max_deviation, case.taps, fstate,
            istate)


def _flat(prefix: str, state: dict, out: dict) -> None:
    for key, v in state.items():
        if isinstance(v, dict):
            _flat(f"{prefix}.{key}", v, out)
        else:
            out[f"{prefix}.{key}"] = v


def run_case(case: SyncCase, device,
             forms=("scan", "events", "slots")) -> dict[str, torch.Tensor]:
    """Every output of the clock recovery on ``case``, on ``device`` (the
    kernels on a card, their plain versions on the CPU), as CPU tensors by
    name: the per-sample form whole (``scan.*``) and chained through its
    state at the case's cuts (``scan_cut.*``), the event form the same way
    (``events.*``, ``events_cut.*``), and kernel D's own outputs on the
    case's slots, padding tail included (``slots.*``).  A chained run must
    equal the whole run key for key.  ``forms`` picks among the three
    groups."""
    x = torch.from_numpy(case.x).to(device)
    n = x.shape[1]
    args = (case.sps, case.max_deviation, case.taps)
    bounds = [0, *case.cuts, n]
    out: dict[str, torch.Tensor] = {}

    if "scan" in forms:
        _run_scan(x, args, bounds, case.state0, out)
    if "events" in forms:
        _run_events(x, args, bounds, case.max_events, out)
    if "slots" in forms:
        _run_slots(x, case, out)
    return {k: v.cpu() for k, v in out.items()}


def _run_scan(x, args, bounds, state0, out) -> None:
    (_, mask, clocks), state = tss.symbol_sync(x, *args, state=state0)
    out["scan.mask"], out["scan.clocks"] = mask, clocks
    _flat("scan.state", state, out)
    parts, state = [], state0
    for a, b in zip(bounds, bounds[1:]):
        (_, m, c), state = tss.symbol_sync(x[:, a:b], *args, state=state)
        parts.append((m, c))
    out["scan_cut.mask"] = torch.cat([p[0] for p in parts], 1)
    out["scan_cut.clocks"] = torch.cat([p[1] for p in parts], 1)
    _flat("scan_cut.state", state, out)


def _run_events(x, args, bounds, max_events, out) -> None:
    kw = {} if max_events is None else {"max_events": max_events}
    (_, mask, clocks), valid, state = tss.symbol_sync_events(
        x, *args, return_state=True, **kw)
    out["events.mask"], out["events.clocks"] = mask, clocks
    out["events.valid"] = valid
    _flat("events.state", state, out)
    parts, state = [], None
    for a, b in zip(bounds, bounds[1:]):
        (_, m, c), v, state = tss.symbol_sync_events(
            x[:, a:b], *args, state=state, return_state=True, **kw)
        parts.append((m, c, v))
    out["events_cut.mask"] = torch.cat([p[0] for p in parts], 1)
    out["events_cut.clocks"] = torch.cat([p[1] for p in parts], 1)
    out["events_cut.valid"] = torch.stack([p[2] for p in parts]).all(0)
    _flat("events_cut.state", state, out)


def _run_slots(x, case, out) -> None:
    n = x.shape[1]
    budget = case.max_events
    if budget is None:
        budget = min(1 << (max(64, int(4 * n / case.sps)) - 1).bit_length(),
                     max(8, n // 4))
    got = kernels.symbol_sync_events_scan(*fresh_event_args(x, case, budget))
    for key, v in zip(("ev_mid", "ev_clock", "fstate", "istate"), got):
        out[f"slots.{key}"] = v


def mismatches(got: dict, want: dict, only: str = "") -> list[str]:
    """The keys (starting with ``only``) on which two :func:`run_case`
    results are not bit-equal."""
    bad = [k for k in want if k.startswith(only) and k not in got]
    for k, g in got.items():
        if not k.startswith(only):
            continue
        w = want.get(k)
        if w is None or g.shape != w.shape or g.dtype != w.dtype \
                or not torch.equal(g, w):
            bad.append(k)
    return bad


def self_mismatches(got: dict) -> list[str]:
    """Keys on which a run disagrees with itself, chained against whole.
    An overflowed channel (``valid`` false) has no meaningful event-form
    output and is left out."""
    bad = []
    for whole, other in (("scan", "scan_cut"), ("events", "events_cut")):
        for k, w in list(got.items()):
            if not k.startswith(whole + "."):
                continue
            o = got[other + k[len(whole):]]
            if whole == "events":
                ok = got["events.valid"] & got["events_cut.valid"]
                if k.endswith(".valid"):
                    continue
                w, o = w[ok], o[ok]
            if not torch.equal(w, o):
                bad.append(f"{other}{k[len(whole):]} != {k}")
    return bad
