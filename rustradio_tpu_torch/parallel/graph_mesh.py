"""Mesh execution of a chain or DAG of blocks (port of
``rustradio_tpu/parallel/graph_mesh.py``): ``shard_chain`` in one shot,
and ``MeshSegment``'s streaming form behind ``Graph.run`` /
``Graph.run_stream(mesh=)``.

Every block that declares a shard plan (``Block.shard_fn``,
``blocks/base.py``) runs with the sample axis sharded over the mesh: the
shards of each block's input are extended by a halo from their left
neighbour (``halo.halo_exchange_left``; zeros, or a carried tail, on the
global shard 0), the block's plan computes each shard's outputs, and the
outputs whose global index lies in the stream-start region the streaming
path never emits are set to 0, so that downstream zero-history blocks
compose exactly.  One host loop drives every shard, each on its own
device's current stream.  On a mesh of several axes the segment runs
along its one named axis on every line of the mesh along it
(``Mesh.lines``), replicated along the others as ``shard_map(..,
in_specs=P(axis))`` is: a shard's positions are those of its coordinate
along the axis, each line ends with the same carries, and the outputs are
those of the line through the mesh's first device.  Each block's filter
history crosses

* shard boundaries as a halo (a copy of the neighbour's tail), and
* chunk boundaries as a carried global tail (``run_chunk``, ``run_batch``),

so the emitted streams are what the single-device streaming runner
produces.

Exactness model: every shardable block has zero-history streaming
semantics, so a shard's left halo is literally its neighbour's input
tail.  Outputs the streaming path never emits (e.g. the quadrature
demod's arg(conj(0)·x₀), a valid-FIR window touching the zero prefix)
appear in the sharded stream as a *leading* region of length ``d_out``;
they are masked to 0 and trimmed from the external outputs at stream
start.  End-of-stream padding artifacts are strictly trailing and are
trimmed to the streaming totals (``Block.shard_total_out``) when a chunk
ends the stream.  A shard's global positions are exact int64 host values
(``in0·r_in + k·L``), at any distance into the stream.  ``shard_chain``
raises :class:`NotShardable` for a chain it cannot plan and never runs it
unsharded in its place.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any

import torch

import torch.distributed as dist

from ..blocks.base import ShardCtx
from .halo import _wire, halo_exchange_left
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
        n = global_len(x, ms.mesh, ms.axis)
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
    """A chain or DAG of blocks planned onto one named axis of a mesh.

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
        totals: dict[tuple[int, int], Any] = {self.ext_in: lambda m: m}
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
            t_in = totals[key]
            t_out = lambda m, _b=b, _t=t_in: _b.shard_total_out(_t(m))
            for i in range(b.n_out):
                ratio[(n.idx, i)] = r_out
                drops[(n.idx, i)] = sf.d_out
                totals[(n.idx, i)] = t_out
        self.plans = plans
        self.ratio = ratio
        self.drops = drops
        #: the streaming runner's total outputs of each port after m input
        #: samples (each member's ``shard_total_out`` chained)
        self.totals = totals
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

    def member_lens(self, consumed: int, n_true: int) -> dict[int, list[int]]:
        """Per-member output lens for a chunk of ``n_true`` samples after
        ``consumed`` (the streaming totals), for the graph's tags."""
        out = {}
        for n in self.nodes:
            out[n.idx] = [self.totals[(n.idx, i)](consumed + n_true)
                          - self.totals[(n.idx, i)](consumed)
                          for i in range(n.block.n_out)]
        return out

    def carries_to_states(self, carries, consumed: int) -> dict:
        """The members' streaming states equivalent to the carried tails,
        given ``consumed`` = true samples fed to the segment so far: what
        the per-chunk runner continues from after a demotion, and what the
        end-of-stream flush reads.  Each member's ``shard_state`` from its
        tail (None for a halo-free member) and the true samples its input
        port has seen (the streaming totals of that port, not the mesh
        grid's length: a valid-conv upstream emits fewer).  Host-state
        members (``RationalResampler``'s offsets) keep host ints."""
        states = {}
        for n in self.nodes:
            key = (n.inputs[0].node.idx, n.inputs[0].index)
            tail = carries.get(n.idx) if self.plans[n.idx].halo else None
            states[n.idx] = n.block.shard_state(tail, self.totals[key](consumed))
        return states

    # ---- the shard body ----
    def _body(self, carries, aux, shards, in0: int = 0):
        """Every member over this process's ``shards`` of the external
        input (one per mesh device), the chunk starting at the global
        input position ``in0``, on every line along the segment's axis;
        returns (the external outputs as per-shard lists, and for each
        line the halo members' input tails on this process's last shard
        of it, by line index: on the line's last shard, the next
        carries)."""
        mesh = self.mesh
        a = mesh.axis_index(self.axis)
        ks = [mesh.coords(j)[a] for j in range(mesh.local)]
        lines = mesh.lines(self.axis)
        vals = {self.ext_in: shards}
        tails = {ln.index: {} for ln in lines}
        for n in self.nodes:
            key = (n.inputs[0].node.idx, n.inputs[0].index)
            xin = vals[key]
            L = int(xin[0].shape[0])
            p = self.plans[n.idx]
            if n.block.n_in > 1:
                # elementwise combiner: all inputs, no halo
                exts = list(zip(*(vals[(q.node.idx, q.index)] for q in n.inputs)))
            elif p.halo:
                for ln in lines:
                    tails[ln.index][n.idx] = xin[ln.local[-1]][L - p.halo:]
                exts = halo_exchange_left(xin, p.halo, mesh, self.axis,
                                          first=carries.get(n.idx))
            else:
                exts = xin
            r_in, r_out = self.ratio[key], self.ratio[(n.idx, 0)]
            base_in = in0 * r_in.numerator // r_in.denominator
            base_out = in0 * r_out.numerator // r_out.denominator
            L_out = L * n.block.interp // n.block.deci
            d = self.drops[(n.idx, 0)]
            outs = [[] for _ in range(n.block.n_out)]
            for j, ext in enumerate(exts):
                k = ks[j]
                g_in, g_out = base_in + k * L, base_out + k * L_out
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

    def _shards(self, x) -> list[torch.Tensor]:
        """This process's shards of ``x``: the global stream (padded with
        zeros to a multiple of ``n_sh * div``) or the shards as given."""
        if isinstance(x, (list, tuple)):
            return list(x)
        if not torch.is_tensor(x):
            x = torch.as_tensor(x)
        pad = (-x.shape[0]) % (self.n_sh * self.div)
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return time_axis_spec(self.mesh, self.axis).shard(x)

    def _share_tails(self, tails: dict) -> dict:
        """The next carries: the input tails on the last shard of a line.
        Where every line lies within one process they are the home line's
        own; where the axis crosses processes, the process holding line
        0's last shard sends them to every other (a broadcast, in the
        members' order, so every process calls it alike; the others' own
        tails serve as the buffers).  Under ``Mesh.replicas()`` each member's
        tail on every line ending here is recorded."""
        mesh = self.mesh
        ends = [ln for ln in mesh.lines(self.axis) if ln.next is None]
        for i in sorted(self._carry_halos):
            mesh.record(tails[ln.index][i] for ln in ends)
        if not mesh.crosses(self.axis):
            return tails[mesh.home(self.axis).index]
        src = mesh.end_owner(self.axis)
        mine = tails[0] if mesh.rank == src else tails[mesh.home(self.axis).index]
        out = {}
        for i in sorted(mine):
            buf = _wire(mine[i].clone())
            dist.broadcast(buf, src=src)
            out[i] = torch.view_as_complex(buf) if mine[i].is_complex() else buf
        return out

    def _aux(self, consumed: int) -> dict:
        """Each member's per-chunk host scalar (``ShardFn.prep``) at its
        input's global position for a chunk after ``consumed`` samples."""
        aux = {}
        for nd in self.nodes:
            p = self.plans[nd.idx]
            if p.prep is not None:
                r = self.ratio[(nd.inputs[0].node.idx, nd.inputs[0].index)]
                aux[nd.idx] = p.prep(consumed * r.numerator // r.denominator)
        return aux

    def _out_len(self, kk, n: int) -> int:
        """Outputs of port ``kk`` on the mesh grid for ``n`` input samples
        (padded to the grid)."""
        r = self.ratio[kk]
        return (n + (-n) % (self.n_sh * self.div)) * r.numerator // r.denominator

    def _advance(self, carries, aux, x, in0: int, first: bool, keeps):
        """The shard body over ``x`` at ``in0``; each external output is
        one tensor on the mesh's first device, its leading drop trimmed
        when ``first`` and cut to ``keeps`` (global counts after that
        trim) when given — in a mesh across processes, this process's
        part of each; the home line's, every line's recorded under
        ``Mesh.replicas()``.  Returns (the new carries, the outputs)."""
        outs, tails = self._body(carries, aux, self._shards(x), in0)
        dev = self.mesh.devices[0]
        trimmed = []
        for j, (o, kk) in enumerate(zip(outs, self.ext_out)):
            per = int(o[0].shape[0])
            lo = self.drops[kk] if first else 0
            hi = None if keeps is None else lo + keeps[j]

            def cut(line, o=o, per=per, lo=lo, hi=hi):
                t = torch.cat([o[i].to(dev) for i in line.local])
                a = line.ks[0] * per  # this part's first global output
                start = min(max(lo - a, 0), t.shape[0])
                stop = t.shape[0] if hi is None else min(max(hi - a, start),
                                                         t.shape[0])
                return t[start:stop]

            self.mesh.record(cut(ln) for ln in self.mesh.lines(self.axis))
            trimmed.append(cut(self.mesh.home(self.axis)))
        return self._share_tails(tails), tuple(trimmed)

    def run(self, carries, aux, x):
        """One shot of the segment over ``x`` (the global stream, or this
        process's shards) from the stream's start: pads the stream to a
        multiple of ``n_sh * div``, runs the shard body and trims each
        output's leading drop, and nothing at its end (``shard_chain``'s
        contract: the trailing samples whose windows reach past the stream
        stay, as the JAX form's one shot keeps them; ``run_chunk`` with
        ``true_len`` trims them).  Returns (the new carries, the external
        outputs: each one tensor on the mesh's first device)."""
        return self._advance(carries, aux, x, 0, True, None)

    def run_chunk(self, carries, x, consumed: int, true_len: int | None = None):
        """Advance the segment by one chunk.

        ``x`` — the chunk (a tensor, or this process's shards); a
        mid-stream chunk must have ``len(x) % (n_sh * div) == 0`` and
        ``len(x) >= min_chunk`` (the Graph demotes the segment otherwise).
        ``consumed`` — true samples fed before this chunk (0: the stream's
        first chunk, whose leading drops are trimmed).  ``true_len`` — the
        unpadded length when this chunk ends the stream, which trims each
        output to the streaming totals; None mid-stream.

        Returns (new_carries, outputs tuple, output lens list: the global
        lens, also in a mesh across processes).
        """
        n = global_len(x, self.mesh, self.axis)
        first = consumed == 0
        fulls = [self._out_len(kk, n) - (self.drops[kk] if first else 0)
                 for kk in self.ext_out]
        keeps = None
        if true_len is not None:
            keeps = tuple(
                min(full, max(0, self.totals[kk](consumed + true_len)
                              - (0 if first else self.totals[kk](consumed))))
                for full, kk in zip(fulls, self.ext_out))
        new_carries, outs = self._advance(carries, self._aux(consumed), x,
                                          consumed, first, keeps)
        lens = fulls if keeps is None else [min(f, k) for f, k in zip(fulls, keeps)]
        return new_carries, outs, list(lens)

    def run_batch(self, carries, xs, consumed: int):
        """Advance the segment over a stack of full chunks — the batched
        runner's form of the mesh path.  ``xs``: ``(nb, chunk)`` stacked
        chunks (or a list of ``nb`` chunk tensors).  Raises NotShardable,
        as the JAX form does, unless the stream is warm (``consumed > 0``:
        its first chunk ran through ``run_chunk``, so no start trims apply)
        and the chunks are full and divisible.  Returns (new_carries,
        stacked outputs tuple, per-chunk lens list).

        The chunks advance one after another through the shard body (the
        JAX form's ``lax.scan`` over its ``shard_map`` program), with no
        CUDA-graph capture: each shard's positions and the per-chunk host
        scalars (``ShardFn.prep``) are host ints and floats that a captured
        graph would bake in, and the resampler's grid phase, the
        translating FIR's rotator and the start masks read them.
        """
        nb = len(xs)
        n = int(xs[0].shape[0])
        if consumed == 0 or n % (self.n_sh * self.div) or n < self.min_chunk:
            raise NotShardable("batch needs warm, full, divisible chunks")
        per = [[] for _ in self.ext_out]
        for b in range(nb):
            c = consumed + b * n
            carries, outs = self._advance(carries, self._aux(c), xs[b], c,
                                          False, None)
            for acc, o in zip(per, outs):
                acc.append(o)
        lens = [self._out_len(kk, n) for kk in self.ext_out]
        return carries, tuple(torch.stack(o) for o in per), lens
