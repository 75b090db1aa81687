"""The port's clock recovery (rustradio_tpu_torch.ops.symbol_sync, on the
plain versions of kernels D and E here) against the JAX package's on the
same numpy inputs, JAX on the CPU.

Inputs are banks of 3 channels x 800 samples of noisy NRZ made from
numpy RandomStates, as tests/test_multichannel.py makes them.

One difference is stated where it shows: XLA's CPU backend contracts
``a*b + c`` into one FMA, while the port (like native ``rr_symbol_sync``)
rounds the product first, as the JAX source writes it.  With products that
round (a 1/6 tap, a clock of 26.667 times a slot count) JAX's ``clocks``
can then differ from the port's in the last place; its masks and decoded
bits do not.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustradio_tpu.models.multichannel import recover_symbols_batch as jbatch
from rustradio_tpu_torch import native
from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
from rustradio_tpu_torch.ops import kernels

# the modules (their package exports functions of the same names)
jss = importlib.import_module("rustradio_tpu.ops.symbol_sync")
tss = importlib.import_module("rustradio_tpu_torch.ops.symbol_sync")

TAP_SETS = [(0.5, 0.5), (0.25, 0.75), (0.4, 0.3, 0.3), (0.25,) * 4, (1 / 6,) * 6]


def _bank(seed, sps, sigma, n=800, c=3):
    rng = np.random.RandomState(seed)
    r = int(round(sps))
    bits = rng.randint(0, 2, (c, n // r + 1)) * 2.0 - 1.0
    x = np.repeat(bits, r, axis=1)[:, :n].astype(np.float32)
    return x + rng.randn(c, n).astype(np.float32) * sigma


def _bits(v, m):
    return np.asarray(v)[np.asarray(m)] > 0


def _np(d):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in d.items()}


# ---- the per-sample recurrence (kernel E's plain version)

@pytest.fixture(scope="module")
def scan_bank():
    """(x, JAX outputs per channel) at sps 10, sigma 0.3, default taps."""
    x = _bank(0, 10.0, 0.3)
    want = [jss.symbol_sync(x[c], 10.0, unroll=1) for c in range(3)]
    return x, [(_np(dict(zip("vmc", o))), _np(s)) for o, s in want]


def test_torch_symbol_sync_bit_equal_to_jax_and_native(scan_bank):
    x, want = scan_bank
    (v, m, c), st = tss.symbol_sync(x, 10.0, device="cpu")
    assert v.shape == m.shape == c.shape == (3, 800) and m.dtype == torch.bool
    for ch, (w, ws) in enumerate(want):
        np.testing.assert_array_equal(v[ch].numpy(), w["v"])
        np.testing.assert_array_equal(m[ch].numpy(), w["m"])
        np.testing.assert_array_equal(c[ch].numpy(), w["c"])
        for k in ws:
            np.testing.assert_array_equal(st[k][ch].numpy(), ws[k], err_msg=k)
        np.testing.assert_array_equal(
            tss.compact(v[ch], m[ch]).numpy(),
            native.symbol_sync_f32(x[ch], 10.0, 0.5, (0.5, 0.5)))
    # one stream, (N,): the JAX shapes, state without the channel axis
    (v1, m1, c1), st1 = tss.symbol_sync(torch.from_numpy(x[1]), 10.0, unroll=16)
    np.testing.assert_array_equal(m1.numpy(), want[1][0]["m"])
    assert st1["fbuf"].shape == (1,) and st1["clock"].shape == ()


def test_torch_symbol_sync_chunks_equal_whole(scan_bank):
    x, _ = scan_bank
    (_, m, c), st = tss.symbol_sync(x, 10.0, device="cpu")
    parts, s = [], None
    for a, b in [(0, 300), (300, 557), (557, 800)]:
        (_, mp, cp), s = tss.symbol_sync(x[:, a:b], 10.0, state=s, device="cpu")
        parts.append((mp, cp))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), m)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), c)
    for k in st:
        assert torch.equal(s[k], st[k]), k


def test_torch_symbol_sync_long_filter_equals_native():
    # a 6-tap boxcar rounds its products: the port equals native exactly;
    # JAX's contracted sums may move its clocks by an ulp, not its symbols
    x = _bank(0, 10.0, 0.3)
    taps = (1 / 6,) * 6
    (v, m, c), _ = tss.symbol_sync(x, 10.0, 0.5, taps, device="cpu")
    for ch in range(3):
        np.testing.assert_array_equal(
            tss.compact(v[ch], m[ch]).numpy(),
            native.symbol_sync_f32(x[ch], 10.0, 0.5, taps))
        (_, jm, jc), _ = jss.symbol_sync(x[ch], 10.0, 0.5, taps, unroll=1)
        np.testing.assert_array_equal(m[ch].numpy(), np.asarray(jm))
        np.testing.assert_array_max_ulp(c[ch].numpy(), np.asarray(jc), maxulp=1)


def test_torch_ted_reduce_bit_equal_to_jax():
    # the gap grid of tests/test_multichannel.py:90-103
    rng = np.random.RandomState(33)
    gaps = np.concatenate([
        rng.uniform(0, 200, 400),
        rng.uniform(0, 2 ** 22, 400),
        np.arange(1, 100, dtype=np.float64) * 36.75,
    ]).astype(np.float32)
    for clock, dev in [(8.0, 0.5), (36.75, 0.5), (5.5, 1.0), (100.0, 0.1)]:
        mx = np.float32(clock + dev)
        want = jax.vmap(lambda g: jss._ted_reduce(g, jnp.float32(clock), mx))(
            jnp.asarray(gaps))
        got = tss._ted_reduce(torch.from_numpy(gaps),
                              torch.full(gaps.shape, clock), float(mx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"clock={clock}")


# ---- the event-driven form (kernel D's plain version)

@pytest.mark.parametrize("sps", [10.0, 26.667])
@pytest.mark.parametrize("sigma", [0.0, 0.1, 0.3])
def test_torch_symbol_sync_events_bit_equal_to_jax(sps, sigma):
    x = _bank(3, sps, sigma)
    (v, m, c), valid = tss.symbol_sync_events(x, sps, device="cpu")
    jv, jm, jc, jvalid = (np.asarray(o) for o in jbatch(
        x, sps, unroll=1, method="events", return_valid=True))
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert valid.all()


@pytest.mark.parametrize("taps", TAP_SETS[1:], ids=lambda t: f"{len(t)}taps")
def test_torch_symbol_sync_events_tap_sets_match_jax(taps):
    # the tap sets of tests/test_multichannel.py:138-139 plus the receiver's
    # 6-tap boxcar, at both rates.  Masks and valid flags are equal; clocks
    # are equal but for the contracted FMA (module docstring): seen on seed
    # 2 with 4 and 6 taps, at most 1 ulp
    for seed, sps in [(2, 10.0), (2, 26.667)]:
        x = _bank(seed, sps, 0.3)
        (v, m, c), valid = tss.symbol_sync_events(x, sps, 0.5, taps,
                                                  device="cpu")
        jv, jm, jc, jvalid = (np.asarray(o) for o in jbatch(
            x, sps, 0.5, taps, unroll=1, method="events", return_valid=True))
        np.testing.assert_array_equal(m.numpy(), jm)
        np.testing.assert_array_equal(valid.numpy(), jvalid)
        np.testing.assert_array_max_ulp(c.numpy(), jc, maxulp=1)
        for ch in range(3):
            np.testing.assert_array_equal(_bits(v[ch], m[ch]), _bits(jv[ch], jm[ch]))


@pytest.mark.parametrize("sps", [10.0, 26.667])
def test_torch_symbol_sync_events_long_runs_match_jax(sps):
    # long same-symbol runs (tests/test_multichannel.py:115-121) exercise
    # the closed-form catch-up from the raw boundary offset
    rng = np.random.RandomState(21)
    bits = np.concatenate([
        np.ones(6), -np.ones(1), np.ones(1), rng.randint(0, 2, 40) * 2.0 - 1.0,
        -np.ones(7), np.ones(1), rng.randint(0, 2, 40) * 2.0 - 1.0])
    x = np.repeat(bits, int(round(sps))).astype(np.float32)
    x += rng.randn(x.size).astype(np.float32) * 0.1
    (v, m, c), valid = tss.symbol_sync_events(torch.from_numpy(x), sps)
    (jv, jm, jc), jvalid = jss.symbol_sync_events(x, sps, unroll=1)
    assert bool(valid) and bool(jvalid) and valid.shape == ()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    if sps == 10.0:
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    else:
        # the contracted FMA (module docstring) moves 27 of JAX's clocks by
        # one ulp here
        np.testing.assert_array_max_ulp(c.numpy(), np.asarray(jc), maxulp=1)
    # decode-equivalent to the exact scan (the JAX contract)
    (sv, sm, _), _ = tss.symbol_sync(torch.from_numpy(x), sps)
    np.testing.assert_array_equal(_bits(v, m), _bits(sv, sm))


def test_torch_symbol_sync_events_overflow_is_invalid():
    # white noise: a crossing nearly every sample overflows 16 slots
    x = np.random.RandomState(5).randn(2, 512).astype(np.float32)
    (_, m, _), valid = tss.symbol_sync_events(x, 8.0, max_events=16,
                                              device="cpu")
    assert not valid.any() and m.shape == (2, 512)
    _, valid = tss.symbol_sync_events(x, 8.0, max_events=512, device="cpu")
    assert valid.all()


def test_torch_symbol_sync_events_chunks_equal_whole():
    x = _bank(4, 12.6, 0.2, n=2400)
    x[:, 900:1400] = 0.7  # a crossing-free gap over a chunk boundary
    (_, m, c), valid = tss.symbol_sync_events(x, 12.6, device="cpu")
    (_, m2, c2), valid2, st = tss.symbol_sync_events(x, 12.6, return_state=True,
                                                     device="cpu")
    assert torch.equal(m2, m) and torch.equal(c2, c)
    parts, st = [], None
    for a, b in [(0, 1000), (1000, 1777), (1777, 2400)]:
        (_, mp, cp), vp, st = tss.symbol_sync_events(
            x[:, a:b], 12.6, max_events=256, state=st, return_state=True,
            device="cpu")
        assert vp.all()
        parts.append((mp, cp))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), m)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), c)
    # the carried state as JAX carries it, channel 0
    (_, jm, _), _, jst = jss.symbol_sync_events(x[0, :1000], 12.6, max_events=256,
                                                unroll=1, return_state=True)
    ev = jst["ev"]
    (_, mp, _), _, st0 = tss.symbol_sync_events(
        torch.from_numpy(x[0, :1000]), 12.6, max_events=256, return_state=True)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(jm))
    for k in ev:
        np.testing.assert_array_equal(st0["ev"][k].numpy(), np.asarray(ev[k]),
                                      err_msg=k)
    assert bool(st0["started"]) and bool(st0["last_sign"]) == bool(jst["last_sign"])


# ---- the batch entry point

def test_torch_recover_symbols_batch_matches_jax():
    x = _bank(11, 10.0, 0.05)
    for method in ("scan", "events"):
        got = recover_symbols_batch(x, 10.0, method=method, return_valid=True,
                                    device="cpu")
        want = jbatch(x, 10.0, unroll=1, method=method, return_valid=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=method)
    vals, mask, clks = recover_symbols_batch(torch.from_numpy(x), 10.0)
    assert vals.shape == mask.shape == clks.shape == (3, 800)
    with pytest.raises(ValueError, match="unknown method"):
        recover_symbols_batch(x, 10.0, method="event", device="cpu")


def test_torch_symbol_sync_wrappers_check_their_inputs():
    x = torch.zeros(2, 64)
    st = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="1..16 taps"):
        kernels.symbol_sync_scan(x, 10.0, 0.5, (0.1,) * 17, st)
    with pytest.raises(ValueError, match=r"\(2, 6\) float32 state"):
        kernels.symbol_sync_scan(x, 10.0, 0.5, (0.5, 0.5), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="needs device="):
        tss.symbol_sync(np.zeros(64, np.float32), 10.0)
    with pytest.raises(ValueError, match="sps must be > 1"):
        tss.symbol_sync_events(x, 1.0)


# ---- the edge inputs that the card tests and chip_smoke.py run on the
# kernels (rustradio_tpu_torch/tools/sync_cases.py): here the plain versions
# against the JAX package

from rustradio_tpu_torch.tools import sync_cases  # noqa: E402

EDGE_CASES = {c.name: c for c in sync_cases.cases()}


def _exact(case) -> bool:
    # taps and rates whose products are exact in f32 leave XLA's contracted
    # FMA nothing to change: bit-equal.  Otherwise (module docstring) JAX's
    # clocks may sit one ulp off the port's and native's.
    return (all(float(t) in (0.5, 0.25, 0.75) for t in case.taps)
            and float(case.sps) == float(np.float32(case.sps)))


def _assert_clocks(case, got, want, what):
    if _exact(case):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _assert_state(case, got, ch, jst, what):
    # the whole final state: bit-equal where the clocks are; else the clock
    # within its last place, and what derives from it (the filter history
    # holds clock - sps; the positions step back by 10 clocks) within that
    # last place's worth, 10 of them for the positions
    assert bool(got["scan.state.last_sign"][ch]) == bool(jst["last_sign"]), what
    ulp = float(np.spacing(np.float32(case.sps + case.max_deviation)))
    for key, tol in (("clock", ulp), ("fbuf", ulp), ("stream_pos", 10 * ulp),
                     ("last_sym_boundary_pos", 10 * ulp),
                     ("next_sym_middle", 10 * ulp)):
        mine = got[f"scan.state.{key}"][ch].numpy()
        np.testing.assert_allclose(
            mine, np.asarray(jst[key]), rtol=0,
            atol=0 if _exact(case) else tol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_torch_symbol_sync_edge_case_matches_jax(name):
    # the per-sample form: masks, clocks and the whole final state against
    # the JAX scan, channel by channel, from the case's entry state; the
    # emitted symbols against native (from the fresh state, which is the
    # only one native starts from); the stream cut at the case's positions
    # against the whole stream
    case = EDGE_CASES[name]
    got = sync_cases.run_case(case, "cpu", forms=("scan",))
    assert sync_cases.self_mismatches(got) == []
    c, n = case.x.shape
    args = (case.sps, case.max_deviation, case.taps)
    for ch in range(c):
        st = case.state0 and {k: v[ch] for k, v in case.state0.items()}
        (_, jm, jc), jst = jss.symbol_sync(case.x[ch], *args, state=st,
                                           unroll=1)
        np.testing.assert_array_equal(got["scan.mask"][ch].numpy(),
                                      np.asarray(jm))
        _assert_clocks(case, got["scan.clocks"][ch].numpy(), np.asarray(jc),
                       f"{name} channel {ch}")
        _assert_state(case, got, ch, jst, f"{name} channel {ch}")
        if case.state0 is None:
            np.testing.assert_array_equal(
                case.x[ch][got["scan.mask"][ch].numpy()],
                native.symbol_sync_f32(case.x[ch], *args))


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_torch_symbol_sync_events_edge_case_matches_jax(name):
    # the event form at the case's slot budget: masks and valid flags equal
    # to the JAX package's, clocks as above, on the channels that did not
    # overflow (an overflowed channel's output is declared untrustworthy by
    # both); chained chunks equal the whole stream
    case = EDGE_CASES[name]
    got = sync_cases.run_case(case, "cpu", forms=("events",))
    assert sync_cases.self_mismatches(got) == []
    if case.x.shape[1] == 0:
        # jnp.flatnonzero(size=) of an empty stream has nothing to trace
        assert got["events.mask"].shape == case.x.shape
        assert got["events.valid"].all()
        return
    _, jm, jc, jvalid = (np.asarray(o) for o in jbatch(
        case.x, case.sps, case.max_deviation, case.taps, unroll=1,
        method="events", max_events=case.max_events, return_valid=True))
    ok = got["events.valid"].numpy()
    np.testing.assert_array_equal(ok, jvalid)
    np.testing.assert_array_equal(got["events.mask"].numpy()[ok], jm[ok])
    _assert_clocks(case, got["events.clocks"].numpy()[ok], jc[ok], name)


def test_torch_symbol_sync_events_scan_takes_counts():
    # the crossing count that ops.symbol_sync_events hands to kernel D:
    # the same results with and without it, and a count of another type,
    # shape or layout is refused
    case = EDGE_CASES["slots1025"]
    args = sync_cases.fresh_event_args(torch.from_numpy(case.x), case, 1025)
    counts = (args[0] < args[1]).sum(1, dtype=torch.int32)
    assert counts.tolist() == sorted(counts.tolist(), reverse=True)
    assert counts[0] == 1025 and 0 < counts[2] < 64
    for g, w in zip(kernels.symbol_sync_events_scan(*args, counts),
                    kernels.symbol_sync_events_scan(*args)):
        assert torch.equal(g, w)
    for bad in (counts.long(), counts[:2], counts.repeat(2)[::2]):
        with pytest.raises(ValueError, match="int32 counts"):
            kernels.symbol_sync_events_scan(*args, bad)
