"""Segment lowering: the FM block pattern -> one kernel B pass (port of
``rustradio_tpu/lowering.py``).

When a fused device segment of a graph contains

    [FloatToComplex ->] FirFilter(real taps, deci) -> QuadratureDemod

the runners execute it as ONE ``kernels.fm_chain_span`` pass (FIR on both
I/Q planes + discriminator) instead of two ops with the filtered stream
between them.  The port lowers on every device: on CUDA tensors the fused
node launches kernel B, on CPU tensors it runs kernel B's plain version,
so the lowering logic itself is tested on the CPU.  With the
FloatToComplex prefix the I/Q planes feed the kernel directly and the
complex stream never materializes.

Numerics: the fused form uses the polynomial fast atan2 (~1e-4 rad, the
trade the reference ships as its ``fast-math`` feature,
src/quadrature_demod.rs:28-29), so lowered output differs from the
composed ops by <~2e-4 rad.  Chunked execution needs no seam dots: the
kernel takes the carried filtered sample as its seed and returns the
chunk's last filtered sample.

State compatibility: the streaming form reads and writes the ORIGINAL
blocks' state (FirFilter's ``{buf, out_off}`` raw-input carry and
QuadratureDemod's 1-sample carry), so lowered and unlowered chunks mix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .blocks.demod import QuadratureDemod
from .blocks.elementwise import FloatToComplex
from .blocks.filters import FirFilter
from .ops import kernels


@dataclasses.dataclass(frozen=True)
class PackedIqChunk:
    """One streaming chunk of a resident packed-plane ring: the FULL packed
    planes plus the chunk's packed-row offset ``row0`` (one packed row is
    deci*128 inputs and 128 outputs), ``g`` tiles of ``tile_rows`` rows.
    ``fm_chain_window`` reads the ring in place at that offset."""

    pr: torch.Tensor
    pi: torch.Tensor
    row0: int
    deci: int
    tile_rows: int
    g: int
    ntaps: int


def _is_fm_fir(block) -> bool:
    return (
        isinstance(block, FirFilter)
        and block.translate is None
        and not np.iscomplexobj(block.taps)
        and len(block.taps) <= 1024
        and block.deci >= 1
    )


def find_fm_pairs(seg, ext_out):
    """Lowerable runs inside a fused segment.

    Returns ``(plans, consumed)``: ``plans`` maps the run's LAST node idx
    (the QuadratureDemod) to a dict describing the fused execution, and
    ``consumed`` is the set of member idxs whose normal execution is
    replaced.  A run only lowers when its interior ports feed nothing
    else (no Tee mid-pattern, not segment outputs).
    """
    by_idx = {n.idx: n for n in seg}
    consumers: dict[tuple[int, int], int] = {}
    for n in seg:
        for p in n.inputs:
            key = (p.node.idx, p.index)
            consumers[key] = consumers.get(key, 0) + 1

    def only_feeds(src_node, dst_node) -> bool:
        key = (src_node.idx, 0)
        return (
            consumers.get(key, 0) == 1
            and key not in ext_out
            and len(dst_node.inputs) == 1
            and dst_node.inputs[0].node.idx == src_node.idx
        )

    plans: dict[int, dict] = {}
    consumed: set[int] = set()
    for n in seg:
        if not isinstance(n.block, QuadratureDemod) or len(n.inputs) != 1:
            continue
        fir = by_idx.get(n.inputs[0].node.idx)
        if fir is None or fir.idx in consumed or not _is_fm_fir(fir.block):
            continue
        if not only_feeds(fir, n):
            continue
        plan = {
            "fir": fir,
            "quad": n,
            "taps": kernels.tapset(fir.block.taps),
            "deci": fir.block.deci,
            "gain": float(n.block.gain),
            "precision": fir.block.precision,
            "f2c": None,
        }
        f2c = by_idx.get(fir.inputs[0].node.idx) if fir.inputs else None
        if (
            f2c is not None
            and isinstance(f2c.block, FloatToComplex)
            and f2c.idx not in consumed
            and only_feeds(f2c, fir)
        ):
            plan["f2c"] = f2c
            consumed.add(f2c.idx)
        consumed.add(fir.idx)
        consumed.add(n.idx)
        plans[n.idx] = plan
    return plans, consumed


def _split(z: torch.Tensor):
    """(re, im) f32 planes of a stream (imag zero for a real one)."""
    if z.is_complex():
        return z.real.float().contiguous(), z.imag.float().contiguous()
    z = z.float().contiguous()
    return z, torch.zeros_like(z)


def _planes(plan, xs):
    if plan["f2c"] is not None:
        return xs[0].float().contiguous(), xs[1].float().contiguous()
    return _split(xs[0])


def _valid_chain(plan, xr, xi, seed):
    """Kernel B on the valid-conv grid of flat f32 planes: output k is
    demod(y_valid[k-1], y_valid[k]) with y_valid[-1] = ``seed``; returns
    (audio of length n_fir, last filtered sample)."""
    taps, deci, precision = plan["taps"], plan["deci"], plan["precision"]
    n_fir = (xr.shape[0] - len(taps)) // deci + 1
    return kernels.fm_chain_span(
        xr, xi, taps, deci, plan["gain"], first=0, count=n_fir, shift=0,
        precision=precision, seed=seed)


def _seed(st_quad: torch.Tensor):
    """QuadratureDemod's carried sample as the kernel seed (None at stream
    start, where the carry is empty)."""
    if st_quad.numel() == 0:
        return None
    return torch.view_as_real(st_quad.to(torch.complex64))[0]


def fused_fm_apply(plan, *xs):
    """Offline form: complex x (pattern A) or (re, im) planes (pattern
    B) -> quadrature_demod(fir_filter(x, taps, deci), gain) with the
    kernel's numerics."""
    xr, xi = _planes(plan, xs)
    audio, _ = _valid_chain(plan, xr, xi, None)
    return audio[1:]


def _fused_fm_chunk_packed(plan, st_fir, st_quad, ck: PackedIqChunk):
    """Streaming form over a packed ring: the kernel computes this chunk's
    window of the demod grid straight from the resident planes, seeded
    with the carried filtered sample, and returns the window's last
    filtered sample as the new carry.  ``st_fir`` rides through untouched
    (the history lives in the ring)."""
    taps, deci = plan["taps"], plan["deci"]
    ntaps = len(taps)
    if ck.deci != deci or ck.ntaps != ntaps:
        raise ValueError(
            "PackedIqRingSource geometry (deci/taps) does not match the "
            "downstream FirFilter's"
        )
    if (ntaps - 1) % deci:
        raise ValueError("packed ring path needs (ntaps-1) % deci == 0")
    seed = _seed(st_quad)
    audio, last = kernels.fm_chain_window(
        ck.pr, ck.pi, taps, deci, plan["gain"], row0=ck.row0, g=ck.g,
        tile_rows=ck.tile_rows, precision=plan["precision"], seed=seed)
    if seed is None:
        # stream start: drop the ramp (windows touching the zero prefix)
        # and the zero-seeded first pair — the valid stream starts at
        # demod(y_valid[0], y_valid[1])
        audio = audio[(ntaps - 1) // deci + 1 :]
    return st_fir, torch.complex(last[:1], last[1:]), audio


def fused_fm_chunk(plan, st_fir, st_quad, *xs):
    """Streaming form over the ORIGINAL blocks' states.

    ``st_fir`` — FirFilter's {"buf": raw-input tail, "out_off": int};
    ``st_quad`` — QuadratureDemod's carried last filtered sample
    ((0,) complex at stream start, (1,) after).  Returns
    (st_fir', st_quad', demod chunk).
    """
    if isinstance(xs[0], PackedIqChunk):
        return _fused_fm_chunk_packed(plan, st_fir, st_quad, xs[0])
    xr, xi = _planes(plan, xs)
    buf = st_fir["buf"]
    if buf.numel():
        br, bi = _split(buf)
        xr, xi = torch.cat([br, xr]), torch.cat([bi, xi])
    out_off = st_fir["out_off"]
    ntaps, deci = len(plan["taps"]), plan["deci"]
    if xr.shape[0] < ntaps:
        return ({"buf": torch.complex(xr, xi), "out_off": out_off}, st_quad,
                xr.new_zeros(0))
    seed = _seed(st_quad)
    audio, last = _valid_chain(plan, xr, xi, seed)
    n_fir = audio.shape[0]
    if seed is None:
        audio = audio[1:]
    consumed = n_fir * deci
    return (
        {"buf": torch.complex(xr[consumed:], xi[consumed:]),
         "out_off": out_off + n_fir},
        torch.complex(last[:1], last[1:]),
        audio,
    )
