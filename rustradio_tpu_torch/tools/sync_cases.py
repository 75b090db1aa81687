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
sample).  And where kernel E's walk from event to event can break: an
emission on a crossing and on the sample before one, several emissions
in one gap between crossings, a step back on the sample before a
crossing and a crossing just after one with the position below 1, gaps
across the position's binade tops (64, 128, 256), and the wideband
cell's own clock over bursts of NRZ between stretches of low-passed
noise.

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
from . import corpus

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
    ev_state0: dict | None = None  # and the event form (None: fresh)


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
    _walk_cases(rng, out)
    _slot_cases(rng, out)
    return out


def _state(c: int, sps: float, nf: int, **rows) -> dict:
    """An entry state of ``c`` channels: the fresh one (clock sps, position
    0, boundary 0, middle sps / 2, last sign low) with ``rows`` put in."""
    sps32 = np.float32(sps)
    st = dict(clock=np.full(c, sps32), last_sign=np.zeros(c, bool),
              stream_pos=np.zeros(c, np.float32),
              last_sym_boundary_pos=np.zeros(c, np.float32),
              next_sym_middle=np.full(c, sps32 / np.float32(2.0)),
              fbuf=np.full((c, nf), sps32))
    for key, v in rows.items():
        st[key] = np.asarray(v, st[key].dtype)
    return st


def _runs(rng, c: int, n: int, sps: float, longest: int, sigma: float):
    """NRZ whose symbols come in runs of 1 to ``longest`` equal bits, so the
    gaps between crossings hold up to ``longest`` symbols: (c, n)."""
    out = np.empty((c, n), np.float32)
    for ch in range(c):
        bits, level = [], 1.0
        while len(bits) < n / sps + 2:
            bits += [level] * rng.randint(1, longest + 1)
            level = -level
        at = np.minimum((np.arange(n) / sps).astype(int), len(bits) - 1)
        out[ch] = np.asarray(bits)[at] + rng.randn(n) * sigma
    return out


def _walk_cases(rng, out: list) -> None:
    """The cases of kernel E's walk from event to event (module docstring)."""
    two = (0.5, 0.5)
    f32 = np.float32

    def add(name, x, sps, state, cuts, taps=two):
        out.append(SyncCase(name, np.ascontiguousarray(x, np.float32), sps,
                            0.5, tuple(taps), tuple(cuts), None, state))

    # an emission on the crossing at sample 5 (middles at 5 and 5.25
    # samples on), on the sample before it (4, 4.5), one and two samples
    # earlier (3.5, 3); the crossing applies (interval 10), and NRZ at 10
    # samples a symbol follows
    d = np.array([5.0, 5.25, 4.0, 4.5, 3.5, 3.0], np.float32)
    x = nrz(rng, len(d), 3 * TILE, 10.0, 0.1)
    x[:, :5], x[:, 5:10] = 0.6, -0.6
    add("emit_at_crossing", x, 10.0, _state(
        len(d), 10.0, 1, clock=np.full(len(d), 10.0), last_sign=np.ones(len(d)),
        stream_pos=np.full(len(d), 20.0), last_sym_boundary_pos=np.full(len(d), 15.0),
        next_sym_middle=f32(20.0) + d), (5, 6, TILE + 3))
    # two, three and more emissions in one gap: runs of up to 10 equal
    # symbols at 2.5 and 4 samples a symbol
    for sps in (2.5, 4.0):
        add(f"gaps_sps{sps}", _runs(rng, 3, 3 * TILE + 7, sps, 10, 0.15), sps,
            None, (TILE - 2, 2 * TILE + 1))
    # 10 clocks are 100 samples.  Channel 0 steps back on sample 0 (position
    # 101 -> 2) and crosses on sample 1; channel 1 steps back on sample 2,
    # the sample before its crossing; channels 2 and 3 step back to 0.5 and
    # 0.75 (a boundary past the position, as only an entry state has) and
    # cross on the next sample, below 1; channel 4 starts at 0.25 and
    # crosses on sample 0, channel 5 at -2.5 and crosses on sample 2
    x = nrz(rng, 6, 2 * TILE + 50, 10.0, 0.2)
    first = [1, 3, 1, 1, 0, 2]
    for ch, at in enumerate(first):
        x[ch, :at] = 0.6
        x[ch, at:at + 6] = -0.6
    add("step_back_edges", x, 10.0, _state(
        6, 10.0, 1, clock=np.full(6, 10.0), last_sign=np.ones(6),
        stream_pos=[101.0, 98.0, 99.5, 99.75, 0.25, -2.5],
        last_sym_boundary_pos=[100.5, 97.0 + 3.5, 100.25, 100.5, 0.125, -3.0],
        next_sym_middle=[103.0, 104.0, 102.0, 101.0, 2.0, 1.0]), (2, 3, 777))
    # gaps across the position's binade tops: at 30 samples a symbol the
    # position runs up to 10 clocks, 300; channels 0-2 enter an odd number
    # of last places under 64, 128 and 256 with their middle just past it,
    # channel 3 is fresh
    tops = np.array([64.0, 128.0, 256.0], np.float32)
    pos = tops - f32(20.0) + np.array([3, 5, 7], np.float32) * np.spacing(tops / 2)
    x = _runs(rng, 4, 3 * TILE + 300, 30.0, 6, 0.1)
    x[:3, :40] = 0.6
    add("binade_tops", x, 30.0, _state(
        4, 30.0, 1, last_sign=[1, 1, 1, 0],
        stream_pos=np.append(pos, 0.0),
        last_sym_boundary_pos=np.append(pos - f32(7.0), 0.0),
        next_sym_middle=np.append(tops + np.spacing(tops), 15.0)),
        (29, TILE + 1))
    # the wideband cell's clock and filter over its kind of channel (two
    # with bursts, one noise alone), five tiles long, chained at arbitrary
    # cuts
    gen = torch.Generator().manual_seed(int(rng.randint(1 << 31)))
    x = corpus.band_nrz("cpu", gen, rng, 3, 5 * TILE + 11, 2, (700, 1600), 900.0)
    add("cell_clock", x.numpy(), corpus.BAND_SPS, None,
        (1, 1500, 2 * TILE + 1, 3333, 4 * TILE), taps=corpus.BAND_TAPS)


def _line(lead: int, gaps, n: int, level: float = 0.6) -> np.ndarray:
    """A row of ``n`` samples at +-``level`` whose sign turns after ``lead``
    samples and then after each of ``gaps``; the last level holds."""
    x = np.empty(n, np.float32)
    at, sign = 0, 1.0
    for g in (lead, *gaps):
        x[at:at + g] = sign * level
        at += g
        sign = -sign
        if at >= n:
            return x
    x[at:] = sign * level
    return x


def _slot_cases(rng, out: list) -> None:
    """The cases where kernel D's straight stretch hands a slot over to its
    general path (csrc/sync_core.cuh, EventsWalker): the first crossing on
    sample 0 of a fresh stream (no boundary before it), a stream cut
    before its first boundary, a long gap whose reduction of the timing
    error starts from a quotient past 2^23 and takes more rounds than the
    stretch holds, intervals exactly at the applied
    range's ends (t = 0.8 mi and 1.2 mx), the filter at both clamps, and
    runs of applied and ignored crossings across a tile's last slot with
    a cut there."""
    two = (0.5, 0.5)

    # sps 17.5 and deviation 2.5: 0.8 mi = 12 and 1.2 mx = 24 in f32, and
    # an interval of 24 is no round of the reduction while the clock is
    # above 16.  Channel 0 measures 12 and 24 (neither applied) between
    # applied ones; channel 1 a run of 23s (the filter at its top clamp),
    # then of 13s (its bottom one); channel 2 the two ends at both clamps
    # (then symbols of one to three clocks: no gap long enough for a whole
    # clock's reduction, whose product the JAX scan may contract)
    ends, tail = [12, 24, 12, 24, 13, 23, 12, 24], [17, 18, 35, 17, 52, 18] * 20
    gaps = [ends + tail, [23] * 12 + [13] * 12 + tail,
            [23] * 8 + [24, 12] + [13] * 8 + [24, 12, 17] + [23] * 3 + [12, 24] + tail]
    x = np.stack([_line(30, g, 3 * TILE + 100) for g in gaps])
    # (two taps and six: kernel D's instances; six whose products are exact,
    # so that no contraction of the JAX scan moves a clock)
    for taps in (two, (0.25, 0.25, 0.125, 0.125, 0.125, 0.125)):
        out.append(SyncCase(f"ted_bounds_taps{len(taps)}", x, 17.5, 2.5, taps,
                            (55, 400, TILE + 5), None))
    # the first crossing on sample 0 of a fresh stream, then NRZ (channel
    # 0), a crossing on samples 0 and 1 (channel 1), on sample 0 and none
    # until after the second cut (channel 2), none until after it (channel
    # 3): each of the last two enters the next call with no boundary
    x = nrz(rng, 4, 2 * TILE + 77, 10.0, 0.2)
    x[:, 0] = 0.5
    x[0, 1:12] = -0.5
    x[1, 1], x[1, 2:15] = -0.5, 0.5
    x[2, 1:300] = 0.5
    x[3, :300] = -0.5
    out.append(SyncCase("first_at_zero", x, 10.0, 0.5, two, (1, 200, TILE + 7),
                        None))
    # a long gap after silence (sps 1.01, deviation 0.95, a clock of
    # 0.09375 whose products with whole numbers of clocks are exact in f32,
    # so that no contraction of the JAX scan changes them).  Before the
    # first crossing 1,572,867 samples passed: the first
    # quotient of the reduction passes 2^24 and rounds two clocks off, and
    # the loop takes four rounds (six is the most it may; no decided
    # quotient leaves more than three), so the slot is handed over.
    # Crossings 1 or 2 samples apart follow (no more whole clocks to reduce
    # by), on the stretch again
    sps, dev = float(np.float32(1.01)), 0.95
    clock = np.float32(0.09375)
    gaps = np.array([1572867], np.int32)
    x = np.stack([-_line(5, rng.randint(1, 3, 2 * TILE), 2 * TILE + 60)
                  for _ in gaps])
    c = len(gaps)
    ev = dict(clock=np.full(c, clock), p_prev=5 - gaps,
              mid_off=np.full(c, 0.25, np.float32), bnd_off=np.zeros(c, np.float32),
              have_boundary=np.ones(c, bool),
              fbuf=np.full((c, 1), clock - np.float32(sps), np.float32))
    out.append(SyncCase("long_gap_rounds", x, sps, dev, two, (7, TILE + 3),
                        x.shape[1], ev_state0=dict(ev=ev, last_sign=np.zeros(c, bool),
                                                   started=np.ones(c, bool))))
    # runs of 1-6 applied crossings (7-9 samples at 8 a symbol) and of 1-6
    # ignored ones (2-3 samples, under 0.8 mi) over 1,100 slots, cut at
    # channel 0's 1024th crossing (its first call's tile ends there) and
    # just after its 1050th
    rows, at = [], []
    for ch in range(3):
        g, applied = [], ch == 1
        while len(g) < 1100:
            g += list(rng.randint(7, 10, rng.randint(1, 7)) if applied
                      else rng.randint(2, 4, rng.randint(1, 7)))
            applied = not applied
        rows.append(g)
        at.append(np.cumsum([20 + ch] + g))
    n = int(min(a[-1] for a in at))
    x = np.stack([_line(20 + ch, rows[ch], n) for ch in range(3)])
    out.append(SyncCase("tile_edge_runs", x, 8.0, 0.5, two,
                        (int(at[0][1023]) + 1, int(at[0][1049]) + 2), None))


def fresh_event_args(x: torch.Tensor, case: SyncCase, max_events: int):
    """Kernel D's arguments for ``x`` (C, N) from the case's entry state of
    the event form (the fresh state where it has none): the crossing slots
    and the states."""
    c, n = x.shape
    k = kernels.sync_consts(case.sps, case.max_deviation, case.taps)
    st = case.ev_state0
    if st is None:
        last = torch.zeros(c, dtype=torch.bool, device=x.device)
        mid0 = float(np.float32(k.sps) / np.float32(2.0) + np.float32(1.0))
        fstate = torch.tensor([k.sps, mid0, 1.0] + [k.sps] * k.nf,
                              device=x.device).expand(c, -1).contiguous()
        istate = torch.tensor([-1, 0, 0], dtype=torch.int32,
                              device=x.device).expand(c, -1).contiguous()
    else:
        ev = {key: torch.as_tensor(v, device=x.device) for key, v in st["ev"].items()}
        last = torch.as_tensor(st["last_sign"], device=x.device)
        fstate = torch.cat([torch.stack([ev["clock"], ev["mid_off"], ev["bnd_off"]], 1),
                            ev["fbuf"].reshape(c, k.nf)], 1).float().contiguous()
        istate = torch.stack([ev["p_prev"], ev["have_boundary"],
                              torch.as_tensor(st["started"], device=x.device)],
                             1).to(torch.int32).contiguous()
    sign = x > 0.0
    changed = torch.cat([sign[:, :1] != last[:, None],
                         sign[:, 1:] != sign[:, :-1]], 1)
    events = tss._crossings(changed, max_events)
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
        _run_events(x, args, bounds, case.max_events, case.ev_state0, out)
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


def _run_events(x, args, bounds, max_events, state0, out) -> None:
    kw = {} if max_events is None else {"max_events": max_events}
    (_, mask, clocks), valid, state = tss.symbol_sync_events(
        x, *args, state=state0, return_state=True, **kw)
    out["events.mask"], out["events.clocks"] = mask, clocks
    out["events.valid"] = valid
    _flat("events.state", state, out)
    parts, state = [], state0
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
