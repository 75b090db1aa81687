"""Clock recovery (port of ``rustradio_tpu/ops/symbol_sync.py``).

Zero-crossing timing error detector + clamped IIR clock filter (reference
src/symbol_sync.rs:115-218), in three forms:

* :func:`symbol_sync`, the per-sample recurrence, bit-exact with the JAX
  package's scan and with native ``rr_symbol_sync``; kernel E
  (``kernels.symbol_sync_scan``) on the card, one block per channel.
* :func:`symbol_sync_events`, the event-driven form: the recurrence
  advances only at zero crossings (kernel D, ``kernels.
  symbol_sync_events_scan``, over each channel's crossing slots), and the
  emission mask is one vectorised pass.  Decode-equivalent to the scan, not
  bit-identical (see the JAX docstring).  The JAX package's event form
  gives the same masks; XLA's CPU backend contracts ``a*b + c`` into FMAs
  that this port (like native) rounds in two steps, which can move JAX's
  clocks by an ulp.
* :func:`recover_symbols`, the native C++ recurrence on the host.

:func:`zero_crossing_sync` is the fixed-clock recovery of
src/zero_crossing.rs, on the native recurrence.

Both device forms take one stream ``(N,)`` or a bank ``(C, N)``, and
return ``(values, mask, clocks)`` arrays of the input's shape (``values``
is the input itself); :func:`compact` gathers the emitted symbols on the
device.  A tensor stays on its device; a numpy input needs ``device=``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from . import kernels

_ted_reduce = kernels.ted_reduce


def _as_bank(x, device) -> tuple[torch.Tensor, bool]:
    """(C, N) contiguous f32 tensor of ``x`` and whether ``x`` was 1-D."""
    if torch.is_tensor(x):
        x = x.to(torch.float32)
    elif device is None:
        raise ValueError("a numpy input needs device= (e.g. 'cuda' or 'cpu')")
    else:
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    if x.dim() not in (1, 2):
        raise ValueError(f"symbol sync takes (N,) or (C, N), got {tuple(x.shape)}")
    one = x.dim() == 1
    return (x.reshape(1, -1) if one else x).contiguous(), one


def _rows(v, c: int, dtype, device) -> torch.Tensor:
    """A per-channel state value (scalar, (C,) or 0-d) as a (C,) tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(-1).expand(c)


def _fbuf_rows(v, c: int, nf: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(
        -1, nf).expand(c, nf)


def _squeeze(one: bool, d: dict) -> dict:
    """State values of a 1-D input lose the channel axis, as in JAX."""
    if not one:
        return d
    return {k: _squeeze(True, v) if isinstance(v, dict) else v[0]
            for k, v in d.items()}


def symbol_sync(x, sps: float, max_deviation: float = 0.5,
                clock_taps=(0.5, 0.5), state=None, unroll: int = 1,
                device=None):
    """Returns ``((values, mask, clocks), final_state)``.

    ``values[i]`` / ``clocks[i]`` are meaningful where ``mask[i]``;
    ``clocks`` carries the clock (sps) before each sample's step.
    ``state`` is a previous call's ``final_state`` (dict of ``clock``,
    ``last_sign``, ``stream_pos``, ``last_sym_boundary_pos``,
    ``next_sym_middle``, ``fbuf``), so chunks chain into the whole stream.
    ``unroll`` is accepted for the JAX signature and changes nothing.
    """
    del unroll
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    xs, one = _as_bank(x, device)
    k = kernels.sync_consts(sps, max_deviation, clock_taps)
    c, dev = xs.shape[0], xs.device
    f = torch.float32
    if state is None:
        st = torch.tensor([k.sps, 0.0, 0.0, 0.0,
                           float(np.float32(k.sps) / np.float32(2.0))]
                          + [k.sps] * k.nf, dtype=f, device=dev).expand(c, -1)
    else:
        st = torch.cat([
            torch.stack([_rows(state["clock"], c, f, dev),
                         _rows(state["last_sign"], c, f, dev),
                         _rows(state["stream_pos"], c, f, dev),
                         _rows(state["last_sym_boundary_pos"], c, f, dev),
                         _rows(state["next_sym_middle"], c, f, dev)], 1),
            _fbuf_rows(state["fbuf"], c, k.nf, dev)], 1)
    mask, clocks, out = kernels.symbol_sync_scan(
        xs, sps, max_deviation, clock_taps, st.contiguous())
    final = _squeeze(one, dict(
        clock=out[:, 0], last_sign=out[:, 1] != 0, stream_pos=out[:, 2],
        last_sym_boundary_pos=out[:, 3], next_sym_middle=out[:, 4],
        fbuf=out[:, 5:]))
    if one:
        return (xs[0], mask[0], clocks[0]), final
    return (xs, mask, clocks), final


def _crossings(changed: torch.Tensor, max_events: int) -> torch.Tensor:
    """The fixed-size crossing list of each row, on the device: the first
    ``max_events`` positions where ``changed``, padded with n (the
    counterpart of ``jnp.flatnonzero(size=, fill_value=n)``), by a cumsum
    and one scatter; the crossings past the budget land in a spare slot
    that is cut off."""
    c, n = changed.shape
    slot = torch.cumsum(changed, 1) - 1
    idx = torch.where(changed & (slot < max_events), slot, max_events)
    out = torch.full((c, max_events + 1), n, dtype=torch.int32,
                     device=changed.device)
    src = torch.arange(n, dtype=torch.int32, device=changed.device)
    out.scatter_(1, idx, src.expand(c, n))
    return out[:, :max_events].contiguous()


def default_max_events(n: int, sps: float) -> int:
    """The crossing budget of an n-sample stream at ``sps``: ~4x the
    crossings of NRZ, pow-2 bucketed, capped at n // 4."""
    want = max(64, int(4 * n / sps))
    return min(1 << (want - 1).bit_length(), max(8, n // 4))


def symbol_sync_events(x, sps: float, max_deviation: float = 0.5,
                       clock_taps=(0.5, 0.5), max_events: int | None = None,
                       unroll: int = 8, state=None, return_state: bool = False,
                       device=None):
    """Event-driven form of :func:`symbol_sync`: the JAX package's
    ``symbol_sync_events`` step for step, each f32 operation rounded on
    its own.

    Returns ``((values, mask, clocks), valid)``; ``valid`` (per channel) is
    False where the input had more than ``max_events`` crossings (results
    untrustworthy there).  ``max_events`` defaults to ~4x the expected
    crossing count for NRZ at ``sps``, pow-2 bucketed, capped at n // 4.
    Streaming: pass the previous chunk's ``state`` and/or
    ``return_state=True`` to get ``((values, mask, clocks), valid,
    new_state)``; chunked output equals the whole-stream output.
    ``unroll`` is accepted for the JAX signature and changes nothing.
    """
    del unroll
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    xs, one = _as_bank(x, device)
    c, n = xs.shape
    dev = xs.device
    if max_events is None:
        max_events = default_max_events(n, sps)
    k = kernels.sync_consts(sps, max_deviation, clock_taps)
    f, i32 = torch.float32, torch.int32
    if state is None:
        last_sign0 = torch.zeros(c, dtype=torch.bool, device=dev)
        started0 = torch.zeros(c, dtype=torch.bool, device=dev)
        fstate = torch.tensor([k.sps, float(np.float32(k.sps) / np.float32(2.0)
                                            + np.float32(1.0)), 1.0]
                              + [k.sps] * k.nf, dtype=f, device=dev).expand(c, -1)
        p_prev = torch.full((c,), -1, dtype=i32, device=dev)
        have_b = torch.zeros(c, dtype=i32, device=dev)
    else:
        ev = state["ev"]
        last_sign0 = _rows(state["last_sign"], c, torch.bool, dev)
        started0 = _rows(state["started"], c, torch.bool, dev)
        fstate = torch.cat([
            torch.stack([_rows(ev["clock"], c, f, dev),
                         _rows(ev["mid_off"], c, f, dev),
                         _rows(ev["bnd_off"], c, f, dev)], 1),
            _fbuf_rows(ev["fbuf"], c, k.nf, dev)], 1)
        p_prev = _rows(ev["p_prev"], c, i32, dev)
        have_b = _rows(ev["have_boundary"], c, i32, dev)
    istate = torch.stack([p_prev, have_b, started0.to(i32)], 1)
    fstate = fstate.contiguous()

    sign = xs > 0.0
    changed = torch.cat([sign[:, :1] != last_sign0[:, None],
                         sign[:, 1:] != sign[:, :-1]], 1)
    events = _crossings(changed, max_events)
    crossings = changed.sum(1)
    valid = crossings <= max_events
    ev_mid, ev_clock, fout, iout = kernels.symbol_sync_events_scan(
        events, n, sps, max_deviation, clock_taps, fstate, istate,
        crossings.clamp(max=max_events).to(i32))

    # ---- vectorised emission mask over all samples
    p_tab = torch.cat([istate[:, :1], events], 1)
    mid_tab = torch.cat([fstate[:, 1:2], ev_mid], 1)
    clk_tab = torch.cat([fstate[:, :1], ev_clock], 1)
    ch = changed.to(torch.int64)
    # slot of the last crossing before each sample; past the budget (an
    # invalid channel) it is clamped to the last slot
    eid = torch.clamp(torch.cumsum(ch, 1) - ch, max=max_events)
    p_k = torch.gather(p_tab, 1, eid)
    mid_k = torch.gather(mid_tab, 1, eid)
    clk_k = torch.gather(clk_tab, 1, eid)
    rel_i = torch.arange(n, dtype=i32, device=dev) - p_k
    rel = rel_i.float()

    def e_of(r, ri):
        unc = torch.floor((r - mid_k) / clk_k).to(i32) + 1
        return torch.minimum(torch.clamp(unc, min=0), ri)

    mask = e_of(rel, rel_i) > e_of(rel - 1.0, rel_i - 1)
    outs = (xs, mask, clk_k)
    if one:
        outs, valid = tuple(o[0] for o in outs), valid[0]
    if state is None and not return_state:
        return outs, valid
    new_state = dict(
        ev=dict(clock=fout[:, 0], p_prev=iout[:, 0] - n, mid_off=fout[:, 1],
                bnd_off=fout[:, 2], have_boundary=iout[:, 1] != 0,
                fbuf=fout[:, 3:]),
        last_sign=sign[:, -1] if n else last_sign0,
        started=torch.ones_like(started0) if n else started0,
    )
    return outs, valid, _squeeze(one, new_state)


def compact(values, mask) -> torch.Tensor:
    """The emitted symbols of a masked stream, ``values[mask]``, on the
    values' device (so only symbols leave the card)."""
    values = torch.as_tensor(values)
    return values[torch.as_tensor(mask, device=values.device)]


def recover_symbols(x, sps: float, max_deviation: float = 0.5,
                    clock_taps=(0.5, 0.5)) -> np.ndarray:
    """Symbol sync from a fresh state, returning the emitted symbols as a
    float32 numpy array, on the native C++ recurrence (``rr_symbol_sync``:
    an exact f32 replication of the JAX package's scan).  A tensor on the
    card is copied to the host.  Raises if the native library cannot be
    built."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return native.symbol_sync_f32(np.asarray(x, np.float32), sps,
                                  max_deviation, np.asarray(clock_taps))


# the largest count of consecutive integers from 1 an f32 holds exactly
_ZC_SEGMENT = 1 << 24


def zero_crossing_sync(x, sps: float, max_deviation: float = 0.5, state=None,
                       device=None):
    """Fixed-clock zero-crossing recovery (src/zero_crossing.rs:26-150):
    emits the sample at sps/2 past each zero crossing, then every sps.

    Runs the native recurrence (``native.zero_crossing_f32``, the exact
    replication of the JAX package's scan) on the host and returns
    ``((values, mask), final_state)`` on ``x``'s device, as the JAX op
    does: ``values`` is ``x`` itself, ``mask`` marks the emitted samples.
    The recurrence reads only the sign of each sample, so the host feeds it
    ``±(i + 1)`` in place of sample i (exact in f32 up to 2^24, so longer
    streams go in segments, the state carried) and reads each emission's
    position off its magnitude.  ``max_deviation`` is accepted for the
    reference's signature and unused there too.  ``state`` is the dict of
    ``native.zero_crossing_f32`` (None: a fresh stream).  A tensor stays on
    its device; a numpy input needs ``device=``.
    """
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    x = _as_bank(x, device)[0].reshape(-1)
    pos_sign = (x > 0).cpu().numpy()
    mask = np.zeros(x.shape[0], bool)
    for lo in range(0, x.shape[0], _ZC_SEGMENT):
        sign = pos_sign[lo:lo + _ZC_SEGMENT]
        idx = np.arange(1, len(sign) + 1, dtype=np.float32)
        vals, state = native.zero_crossing_f32(np.where(sign, idx, -idx), sps,
                                               state)
        mask[lo + np.abs(vals).astype(np.int64) - 1] = True
    if x.shape[0] == 0:
        state = native.zero_crossing_f32(np.zeros(0, np.float32), sps, state)[1]
    return (x, torch.from_numpy(mask).to(x.device)), state
