"""A chain of blocks on a mesh, in one shot (port of the one-shot half of
``rustradio_tpu/parallel/graph_mesh.py``).

Every block that declares a shard plan (``Block.shard_fn``,
``blocks/base.py``) runs with the sample axis sharded over the mesh: the
shards of each block's input are extended by a halo from their left
neighbour (``halo.halo_exchange_left``; zeros, or a carried tail, on the
global shard 0), the block's plan computes each shard's outputs, and the
outputs whose global index lies in the stream-start region the streaming
path never emits are set to 0, so that downstream zero-history blocks
compose exactly.  One host loop drives every shard, each on its own
device's current stream.

Exactness model: every shardable block has zero-history streaming
semantics, so a shard's left halo is literally its neighbour's input
tail.  Outputs the streaming path never emits (e.g. the quadrature
demod's arg(conj(0)·x₀), a valid-FIR window touching the zero prefix)
appear in the sharded stream as a *leading* region of length ``d_out``;
they are masked to 0 and trimmed from the external outputs at stream
start.  End-of-stream padding artifacts are strictly trailing.

The streaming half — carries across chunks (``carries_to_states``,
``run_chunk``, ``run_batch``) and the Graph runners' ``mesh=`` — is not
ported yet.  ``shard_chain`` raises :class:`NotShardable` for a chain it
cannot plan and never runs it unsharded in its place.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any

import torch

from ..blocks.base import ShardCtx
from .halo import halo_exchange_left
from .mesh import global_len, on_device, time_axis_spec


class NotShardable(Exception):
    """This chain or segment cannot run on a mesh."""


class _Port:
    def __init__(self, node, index=0):
        self.node, self.index = node, index


class _Node:
    def __init__(self, block, idx):
        self.block, self.idx = block, idx
        self.inputs: list[_Port] = []


def chain_segment(block_seq, mesh, axis: str = "time") -> "MeshSegment":
    """The :class:`MeshSegment` of a linear chain of blocks: one external
    input into the first block, the last block's port 0 out."""
    nodes = []
    prev = _Node(None, -1)
    for i, b in enumerate(block_seq):
        n = _Node(b, i)
        n.inputs = [_Port(prev)]
        nodes.append(n)
        prev = n
    return MeshSegment(nodes, [(-1, 0)], [(len(block_seq) - 1, 0)], mesh, axis)


def shard_chain(block_seq, mesh, axis: str = "time"):
    """A sharded function from a linear chain of blocks: each block's
    ``shard_fn`` halo/grid plan, zero stream history, one shot.  The
    returned ``f(x)`` takes the global stream (a tensor, or this
    process's shards as a list), whose length must divide
    ``mesh.shape[axis] * div``, and emits the streaming-aligned output
    with the leading start-drop trimmed — exactly what the offline block
    chain produces over the same input, save any trailing samples whose
    input windows extend past the stream — as one tensor on the mesh's
    first device (this process's part of it, in a mesh across processes).
    """
    ms = chain_segment(block_seq, mesh, axis)
    aux = {i: p.prep(0) for i, p in ms.plans.items() if p.prep is not None}

    def f(x):
        n = global_len(x, ms.mesh)
        if n % (ms.n_sh * ms.div):
            raise ValueError(
                f"stream length {n} must divide mesh*div = {ms.n_sh * ms.div}"
            )
        if n < ms.min_chunk:
            raise ValueError(f"stream shorter than the halo ({ms.min_chunk})")
        # zero stream history: no carries, the halo of the global shard 0
        # is zeros of each member's input
        _, outs = ms.run({}, aux, x)
        return outs[0]

    return f


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class MeshSegment:
    """A chain or DAG of blocks planned onto a 1-D mesh axis.

    ``nodes`` — topo-ordered nodes; ``ext_in``/``ext_out`` — the
    segment's external ports as (node_idx, port) keys.  Raises
    NotShardable when the plan is impossible (multiple external inputs, a
    member without a shard plan, a flush hook whose end-of-stream drain
    the sharded form can't reproduce).
    """

    def __init__(self, nodes, ext_in, ext_out, mesh, axis: str):
        if len(ext_in) != 1:
            raise NotShardable("mesh segments take exactly one external input")
        self.nodes = list(nodes)
        self.ext_in = ext_in[0]
        self.ext_out = list(ext_out)
        self.mesh = mesh
        self.axis = axis
        self.n_sh = int(mesh.shape[axis])

        member = {n.idx for n in self.nodes}
        plans: dict[int, Any] = {}
        ratio: dict[tuple[int, int], Fraction] = {self.ext_in: Fraction(1)}
        drops: dict[tuple[int, int], int] = {self.ext_in: 0}
        div = 1
        min_chunk = 1
        for n in self.nodes:
            b = n.block
            if b.n_in < 1 or hasattr(b, "flush") or hasattr(b, "flush_with_state"):
                raise NotShardable(f"{b.name()} not mesh-eligible")
            keys = [(p.node.idx, p.index) for p in n.inputs]
            for key in keys:
                if key != self.ext_in and key[0] not in member:
                    raise NotShardable(
                        "mesh segments take exactly one external input"
                    )
            if len(keys) > 1:
                # multi-input combiner: all inputs must share one rate and
                # one stream-start drop, or the elementwise combine would
                # misalign the streams
                if len({ratio[k] for k in keys}) != 1 or len(
                    {drops[k] for k in keys}
                ) != 1:
                    raise NotShardable(
                        f"{b.name()} inputs differ in rate or drop"
                    )
            key = keys[0]
            sf = b.shard_fn(drops[key])
            if sf is None:
                raise NotShardable(f"{b.name()} has no shard plan")
            plans[n.idx] = sf
            r_in = ratio[key]
            # the member's local input length is L0 * r_in; it must be an
            # integer divisible by sf.div and large enough for the halo
            dd = sf.div * r_in.denominator
            div = _lcm(div, dd // math.gcd(r_in.numerator, dd))
            if sf.halo:
                min_chunk = max(
                    min_chunk, -(-(sf.halo * r_in.denominator) // r_in.numerator)
                )
            r_out = r_in * Fraction(b.interp, b.deci)
            for i in range(b.n_out):
                ratio[(n.idx, i)] = r_out
                drops[(n.idx, i)] = sf.d_out
        self.plans = plans
        self.drops = drops
        self.div = div
        # per-shard local input length must cover every member's halo
        self.min_chunk = min_chunk * self.n_sh
        self._carry_halos = {i: p.halo for i, p in plans.items() if p.halo}

    # ---- carries ----
    def _input_dtypes(self, dtype) -> dict[int, torch.dtype]:
        """Dtype of every member's input stream: the chain's offline form
        on a short zero stream of ``dtype`` on the CPU, long enough for
        every member's window."""
        m = 4 * (self.min_chunk // self.n_sh + self.div)
        vals = {self.ext_in: torch.zeros(m, dtype=dtype)}
        dts = {}
        for n in self.nodes:
            ins = [vals[(p.node.idx, p.index)] for p in n.inputs]
            dts[n.idx] = ins[0].dtype
            out = n.block.apply(*ins)
            for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
                vals[(n.idx, i)] = o
        return dts

    def init_carries(self, x) -> dict[int, torch.Tensor]:
        """Zero carries (each member's halo of input history) matching the
        stream dtypes, on the mesh's first device."""
        first = x[0] if isinstance(x, (list, tuple)) else x
        halos = self._carry_halos
        if not halos:
            return {}
        dtype = first.dtype if torch.is_tensor(first) else torch.from_numpy(
            first[:0]).dtype
        dts = self._input_dtypes(dtype)
        dev = self.mesh.devices[0]
        return {i: torch.zeros(halos[i], dtype=dts[i], device=dev) for i in halos}

    # ---- the shard body ----
    def _body(self, carries, aux, shards):
        """Every member over this process's ``shards`` of the external
        input; returns (the external outputs as per-shard lists, each
        halo member's input tail on the last shard: its next carry)."""
        mesh = self.mesh
        vals = {self.ext_in: shards}
        tails = {}
        for n in self.nodes:
            key = (n.inputs[0].node.idx, n.inputs[0].index)
            xin = vals[key]
            L = int(xin[0].shape[0])
            p = self.plans[n.idx]
            if n.block.n_in > 1:
                # elementwise combiner: all inputs, no halo
                exts = list(zip(*(vals[(q.node.idx, q.index)] for q in n.inputs)))
            elif p.halo:
                tails[n.idx] = xin[-1][L - p.halo:]
                exts = halo_exchange_left(xin, p.halo, mesh, self.axis,
                                          first=carries.get(n.idx))
            else:
                exts = xin
            L_out = L * n.block.interp // n.block.deci
            d = self.drops[(n.idx, 0)]
            outs = [[] for _ in range(n.block.n_out)]
            for j, ext in enumerate(exts):
                k = mesh.first + j
                g_in, g_out = k * L, k * L_out
                ctx = ShardCtx(g_in=g_in, g_out=g_out, k=k, aux=aux.get(n.idx))
                with on_device(mesh.devices[j]):
                    y = p.fn(ext, L, ctx)
                for i, yy in enumerate(y if isinstance(y, tuple) else (y,)):
                    if g_out < d:  # outputs streaming never emits
                        m = min(d - g_out, yy.shape[0])
                        yy = torch.cat([yy.new_zeros(m), yy[m:]])
                    outs[i].append(yy)
            for i, o in enumerate(outs):
                vals[(n.idx, i)] = o
        return [vals[kk] for kk in self.ext_out], tails

    def run(self, carries, aux, x):
        """One shot of the segment over ``x`` (the global stream, or this
        process's shards) from the stream's start: pads the stream to a
        multiple of ``n_sh * div``, runs the shard body and trims each
        output's leading drop.  Returns (the new carries, the external
        outputs: each one tensor on the mesh's first device)."""
        n_sh, div = self.n_sh, self.div
        if isinstance(x, (list, tuple)):
            shards = list(x)
        else:
            if not torch.is_tensor(x):
                x = torch.as_tensor(x)
            pad = (-x.shape[0]) % (n_sh * div)
            if pad:
                x = torch.cat([x, x.new_zeros(pad)])
            shards = time_axis_spec(self.mesh, self.axis).shard(x)
        outs, new_carries = self._body(carries, aux, shards)
        dev = self.mesh.devices[0]
        trimmed = []
        for o, kk in zip(outs, self.ext_out):
            o = torch.cat([s.to(dev) for s in o])
            if self.mesh.first == 0:
                o = o[self.drops[kk]:]
            trimmed.append(o)
        return new_carries, tuple(trimmed)
