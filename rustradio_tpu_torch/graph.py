"""Flowgraph builder and runners (port of ``rustradio_tpu/graph.py``).

A graph is a DAG evaluated in topological order, with

* ``run(device)`` — offline mode: whole streams in one pass;
* ``compile_device_loop(chunk_size, n_chunks, device)`` — a streaming
  loop over fixed-size chunks with each block's carried state and every
  sink folding on the device, synchronising once at the end.  On a CUDA
  device the n-chunk loop is captured once into a CUDA graph and replayed
  (one submission instead of a Python dispatch per op); on the CPU it is
  the plain loop.

Maximal runs of device-domain blocks form segments; inside a segment the
FM pattern ``[FloatToComplex ->] FirFilter -> QuadratureDemod`` lowers to
one kernel B pass (``lowering.py``).  PyTorch runs eagerly, so a segment
is a plain loop over its members (recorded once into the device loop's
CUDA graph on the card).  ``run_stream``, checkpoints, meshes
and profiling come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import lowering
from .blocks.base import Block, SourceBlock
from .ops import kernels
from .streams import Tag

_MAX_CAPTURES = 8  # captured device loops kept per compiled loop


@dataclasses.dataclass(frozen=True)
class Port:
    node: "Node"
    index: int


class Node:
    def __init__(self, graph: "Graph", block: Block, idx: int):
        self.graph = graph
        self.block = block
        self.idx = idx
        self.inputs: list[Port] = []

    def __getitem__(self, i: int) -> Port:
        if i >= self.block.n_out:
            raise IndexError(f"{self.block.name()} has {self.block.n_out} outputs")
        return Port(self, i)

    def out(self) -> Port:
        return Port(self, 0)


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self._segs: dict[int, list[Node]] | None = None
        self._seg_member: dict[int, int] = {}
        self._plans: dict[int, tuple] = {}

    def add(self, block: Block, *inputs) -> Node:
        node = Node(self, block, len(self.nodes))
        ins: list[Port] = []
        for i in inputs:
            if isinstance(i, Node):
                ins.append(i.out())
            elif isinstance(i, Port):
                ins.append(i)
            else:
                raise TypeError(f"cannot connect {i!r}")
        if len(ins) != block.n_in:
            raise ValueError(
                f"{block.name()} takes {block.n_in} inputs, got {len(ins)}"
            )
        node.inputs = ins
        self.nodes.append(node)
        self._segs = None
        return node

    def chain(self, *blocks) -> Node:
        """Connect blocks in sequence (the reference's blockchain! macro,
        src/lib.rs:404-413)."""
        prev: Node | None = None
        for b in blocks:
            if isinstance(b, (Node, Port)):
                prev = b if isinstance(b, Node) else b.node
                continue
            prev = self.add(b, *([prev] * b.n_in if prev is not None else []))
        return prev

    # ---- segments ----
    def _topo(self) -> list[Node]:
        # nodes are appended after their inputs, so insertion order is topo
        # as long as users build forward; verify anyway.
        seen = set()
        for n in self.nodes:
            for p in n.inputs:
                if p.node.idx not in seen and p.node.idx > n.idx:
                    raise ValueError("graph has a cycle or backward edge")
            seen.add(n.idx)
        return self.nodes

    @staticmethod
    def _fusable(n: Node) -> bool:
        return (
            n.block.domain == "device"
            and n.block.n_out > 0
            and not isinstance(n.block, SourceBlock)
        )

    def _segments(self) -> dict[int, list[Node]]:
        """Maximal contiguous runs (length >= 2) of device nodes, keyed by
        the first member's idx."""
        if self._segs is None:
            segs: dict[int, list[Node]] = {}
            cur: list[Node] = []
            for n in self._topo():
                if self._fusable(n):
                    cur.append(n)
                    continue
                if len(cur) > 1:
                    segs[cur[0].idx] = cur
                cur = []
            if len(cur) > 1:
                segs[cur[0].idx] = cur
            self._segs = segs
            self._seg_member = {m.idx: s[0].idx for s in segs.values() for m in s}
            self._plans = {}
        return self._segs

    def _segment_io(self, seg: list[Node]):
        member = {n.idx for n in seg}
        ext_in: list[tuple[int, int]] = []
        for n in seg:
            for p in n.inputs:
                key = (p.node.idx, p.index)
                if p.node.idx not in member and key not in ext_in:
                    ext_in.append(key)
        ext_out: list[tuple[int, int]] = []
        for m in self.nodes:
            if m.idx in member:
                continue
            for p in m.inputs:
                key = (p.node.idx, p.index)
                if p.node.idx in member and key not in ext_out:
                    ext_out.append(key)
        return ext_in, ext_out

    def _segment_plan(self, seg: list[Node]):
        """(ext_in, ext_out, fm plans, consumed idxs) of a segment, cached."""
        key = seg[0].idx
        if key not in self._plans:
            ext_in, ext_out = self._segment_io(seg)
            plans, consumed = lowering.find_fm_pairs(seg, set(ext_out))
            self._plans[key] = (ext_in, ext_out, plans, consumed)
        return self._plans[key]

    def _run_segment(self, seg, values, tags=None, states=None):
        """Execute a segment, FM pairs lowered.  Offline when ``states`` is
        None (and then maps ``tags`` through every member), else one chunk
        of the streaming form.  Reads its external inputs from ``values``,
        writes its external outputs there, and returns the members' new
        states."""
        ext_in, ext_out, plans, consumed = self._segment_plan(seg)
        vals = {k: values[k] for k in ext_in}
        lens: dict[int, list[int]] = {}
        new_states: dict[int, Any] = {}
        for n in seg:
            if n.idx in plans:
                plan = plans[n.idx]
                lead = plan["f2c"] or plan["fir"]
                xs = [vals[(p.node.idx, p.index)] for p in lead.inputs]
                fir, quad, f2c = plan["fir"], plan["quad"], plan["f2c"]
                if states is None:
                    out = lowering.fused_fm_apply(plan, *xs)
                    n_in = xs[0].shape[0]
                    n_fir = (n_in - len(plan["taps"])) // plan["deci"] + 1
                    lens[fir.idx] = [max(n_fir, 0)]
                    if f2c is not None:
                        lens[f2c.idx] = [n_in]
                else:
                    new_states[fir.idx], new_states[quad.idx], out = (
                        lowering.fused_fm_chunk(plan, states[fir.idx],
                                                states[quad.idx], *xs))
                    if f2c is not None:
                        new_states[f2c.idx] = states[f2c.idx]
                vals[(n.idx, 0)] = out
                lens[n.idx] = [out.shape[0]]
                continue
            if n.idx in consumed:
                continue  # executed by the fused node above
            xs = [vals[(p.node.idx, p.index)] for p in n.inputs]
            if states is None:
                out = n.block.apply(*xs)
            else:
                new_states[n.idx], out = n.block.apply_chunk(states[n.idx], *xs)
            outs = out if isinstance(out, tuple) else (out,)
            for k, o in enumerate(outs):
                vals[(n.idx, k)] = o
            lens[n.idx] = [o.shape[0] for o in outs]
        for key in ext_out:
            values[key] = vals[key]
        if tags is not None:
            for n in seg:
                in_tags = [tags.get((p.node.idx, p.index), []) for p in n.inputs]
                for k, ot in enumerate(n.block.process_tags(in_tags, lens[n.idx])):
                    tags[(n.idx, k)] = ot
        return new_states

    # ---- offline ----
    def run(self, device="cpu") -> None:
        """Offline mode: evaluate every block once over whole streams,
        sources emitting on ``device``."""
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list[Tag]] = {}
        segs = self._segments()
        for node in self._topo():
            first = self._seg_member.get(node.idx)
            if first is not None:
                if first == node.idx:
                    self._run_segment(segs[first], values, tags)
                continue
            b = node.block
            xs = [values[(p.node.idx, p.index)] for p in node.inputs]
            in_tags = [tags.get((p.node.idx, p.index), []) for p in node.inputs]
            src_tags = None
            if isinstance(b, SourceBlock):
                out = b.apply(device)
                src_tags = b.emit_tags(0, b.total_len())
            else:
                out = b.apply(*xs)
            if b.n_out == 0:
                if hasattr(b, "accept_tags") and in_tags:
                    b.accept_tags(in_tags[0], 0)
                continue
            outs = out if isinstance(out, tuple) else (out,)
            if src_tags is not None:
                otags = [src_tags] * b.n_out
            else:
                otags = b.process_tags(in_tags, [o.shape[0] for o in outs])
            for k, (o, ot) in enumerate(zip(outs, otags)):
                values[(node.idx, k)] = o
                tags[(node.idx, k)] = ot

    # ---- device-resident streaming ----
    def compile_device_loop(self, chunk_size: int, n_chunks: int, device,
                            cuda_graph: bool = True):
        """The whole streaming run as one loop over chunks on ``device``.

        Each of the ``n_chunks`` iterations runs {source emit -> segments
        (FM pairs as one kernel) -> sink fold}.  Block state and the sink
        folds stay on the device; nothing in the loop waits for the device,
        and the loop synchronises once at the end.

        On a CUDA device the loop is captured into a ``torch.cuda.CUDAGraph``
        at its first call and replayed after (``cuda_graph=False`` keeps
        the eager loop, whose folds a replay equals bit for bit).  Source
        offsets are baked into the captured launches, so a capture belongs
        to one ``offset0`` reduced by the sources' periods; the last
        ``_MAX_CAPTURES`` are kept and another offset captures again.  A
        warm-up pass of the loop on a side stream comes before each
        capture, so that everything that allocates, uploads or builds
        (kernel library, device taps, resident source data) happens outside
        it; states and carries are initialised inside the captured region,
        so every replay starts clean.  The capture runs inside
        ``kernels.recording()``, which counts the launches recorded there
        apart and keeps their device taps alive; ``kernels.replayed`` adds
        them to ``kernels.LAUNCHES`` after each replay.  Blocks and folds
        must not wait for the device or read a value back.

        Requirements (raises ValueError otherwise):

        * every sink (n_out == 0) defines ``fold(carry, *chunks)`` and
          ``fold_init(device)`` — a device-side reduction;
        * every other non-source block is device-domain;
        * a source declaring ``emit_period()`` (its ring or vector length)
          has a period that is a multiple of ``chunk_size``; its offsets
          are reduced mod that period;
        * tags are not processed.

        Returns ``fn(offset0) -> {sink node idx: fold carry}``; ``offset0``
        must be a multiple of ``chunk_size``.
        """
        if n_chunks < 1:
            raise ValueError("device loop needs n_chunks >= 1")
        device = torch.device(device)
        for node in self._topo():
            b = node.block
            if isinstance(b, SourceBlock):
                continue
            if b.n_out == 0:
                if not hasattr(b, "fold"):
                    raise ValueError(f"{b.name()} has no device fold")
            elif b.domain != "device":
                raise ValueError(f"{b.name()} cannot join the device loop")
        periods: dict[int, int] = {}
        for node in self.nodes:
            b = node.block
            per = getattr(b, "emit_period", None)
            if isinstance(b, SourceBlock) and per is not None:
                p = per()
                if p % chunk_size:
                    raise ValueError(
                        f"{b.name()} period {p} must be a multiple of "
                        f"chunk_size for the device loop"
                    )
                periods[node.idx] = p
        segs = self._segments()

        def step(states, carries, offset0: int, index: int) -> None:
            vals: dict[tuple[int, int], Any] = {}
            for node in self._topo():
                b = node.block
                first = self._seg_member.get(node.idx)
                if first is not None:
                    if first == node.idx:
                        states.update(self._run_segment(segs[first], vals,
                                                        states=states))
                    continue
                if isinstance(b, SourceBlock):
                    p = periods.get(node.idx)
                    if p is not None:
                        offset = offset0 % p + index % (p // chunk_size) * chunk_size
                    else:
                        offset = offset0 + index * chunk_size
                    out = b.emit(offset, chunk_size, device)
                    outs = out if isinstance(out, tuple) else (out,)
                    for port, o in enumerate(outs):
                        vals[(node.idx, port)] = o
                    continue
                xs = [vals[(p.node.idx, p.index)] for p in node.inputs]
                if b.n_out == 0:
                    carries[node.idx] = b.fold(carries[node.idx], *xs)
                    continue
                states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
                outs = out if isinstance(out, tuple) else (out,)
                for port, o in enumerate(outs):
                    vals[(node.idx, port)] = o

        def run_loop(offset0: int):
            states = {
                n.idx: n.block.init_state()
                for n in self.nodes
                if not isinstance(n.block, SourceBlock) and n.block.n_out > 0
            }
            carries = {
                n.idx: n.block.fold_init(device)
                for n in self.nodes
                if n.block.n_out == 0
            }
            for index in range(n_chunks):
                step(states, carries, offset0, index)
            return carries

        def check(offset0: int) -> None:
            if offset0 % chunk_size:
                raise ValueError(
                    f"offset0 {offset0} is not a multiple of chunk_size "
                    f"{chunk_size}"
                )

        def fn(offset0: int = 0):
            check(offset0)
            carries = run_loop(offset0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return carries

        if device.type != "cuda" or not cuda_graph:
            return fn

        source_idxs = [n.idx for n in self.nodes
                       if isinstance(n.block, SourceBlock)]
        # offset0 -> (graph, its carries, the wrappers' record of the capture)
        captures: dict[tuple, tuple] = {}

        def capture(offset0: int):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                run_loop(offset0)  # warm-up: allocate, upload, build
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with kernels.recording() as record, torch.cuda.graph(graph):
                carries = run_loop(offset0)
            return graph, carries, record

        def replay_fn(offset0: int = 0):
            check(offset0)
            key = tuple(offset0 % periods[i] if i in periods else offset0
                        for i in source_idxs)
            with torch.cuda.device(device):
                entry = captures.get(key)
                if entry is None:
                    if len(captures) >= _MAX_CAPTURES:
                        del captures[next(iter(captures))]
                    entry = captures[key] = capture(offset0)
                graph, carries, record = entry
                graph.replay()
                kernels.replayed(record)
                out = {idx: c.clone() for idx, c in carries.items()}
                torch.cuda.synchronize(device)
            return out

        return replay_fn
