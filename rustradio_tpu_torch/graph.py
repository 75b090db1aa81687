"""Flowgraph builder and runners (port of ``rustradio_tpu/graph.py``).

A graph is a DAG evaluated in topological order, with

* ``run(device)`` — offline mode: whole streams in one pass;
* ``run_stream(chunk_size, ..., device)`` — streaming mode: fixed-size
  chunks with each block's carried state, semantically the offline
  stream, with checkpoint/resume (``utils.checkpoint``), cancellation
  (``cancel_token()``) and an end-of-stream drain (``flush()``);
* ``compile_device_loop(chunk_size, n_chunks, device)`` — a streaming
  loop over fixed-size chunks with each block's carried state and every
  sink folding on the device, synchronising once at the end.  On a CUDA
  device the n-chunk loop is captured once into a CUDA graph and replayed
  (one submission instead of a Python dispatch per op); on the CPU it is
  the plain loop.

Maximal runs of device-domain blocks form segments; inside a segment the
FM pattern ``[FloatToComplex ->] FirFilter -> QuadratureDemod`` lowers to
one kernel B pass (``lowering.py``), offline and in both streaming
runners.  PyTorch runs eagerly, so a segment is a plain loop over its
members (recorded once into the device loop's CUDA graph on the card).
The JAX package's batched scan runner (``run_stream(scan_chunks=)``),
meshes and profiling come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import lowering
from ._device import target_device
from .blocks.base import Block, SourceBlock
from .ops import kernels
from .streams import Tag
from .utils.checkpoint import load_checkpoint, save_checkpoint

_MAX_CAPTURES = 8  # captured device loops kept per compiled loop


def _length(o) -> int:
    """Samples in a stream value (a tensor, or a list of PDUs); 0 for a
    value without a length (a packed-ring chunk)."""
    if torch.is_tensor(o):
        return o.shape[0] if o.dim() else 0
    return len(o) if hasattr(o, "__len__") else 0


def _cat_outputs(a, b):
    """Two outputs of the same port, one after the other (flush drain)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, list) or isinstance(b, list):
        return list(a) + list(b)
    return torch.cat([a, b.to(a.device)])


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


class CancellationToken:
    """Cooperative cancellation (reference src/graph.rs:295-319): the
    runners check it between blocks (``run``) or chunks (``run_stream``)
    and stop without the end-of-stream drain."""

    def __init__(self):
        self._cancelled = False

    def cancel(self):
        self._cancelled = True

    def is_cancelled(self) -> bool:
        return self._cancelled


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self._token = CancellationToken()
        self._segs: dict[int, list[Node]] | None = None
        self._seg_member: dict[int, int] = {}
        self._plans: dict[int, tuple] = {}

    def cancel_token(self) -> CancellationToken:
        return self._token

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
            and not hasattr(n.block, "set_tags")
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
        None, else one chunk of the streaming form; maps ``tags`` (when
        given) through every member.  Reads its external inputs from
        ``values``, writes its external outputs there, and returns the
        members' new states."""
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
                    # the filter's outputs this chunk (a packed-ring chunk
                    # leaves out_off as it is: one per demod output then)
                    n_fir = (new_states[fir.idx]["out_off"]
                             - states[fir.idx]["out_off"])
                    lens[fir.idx] = [max(n_fir, out.shape[0])]
                    if f2c is not None:
                        new_states[f2c.idx] = states[f2c.idx]
                        lens[f2c.idx] = [_length(xs[0])]
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
            lens[n.idx] = [_length(o) for o in outs]
        for key in ext_out:
            values[key] = vals[key]
        if tags is not None:
            for n in seg:
                in_tags = [tags.get((p.node.idx, p.index), []) for p in n.inputs]
                for k, ot in enumerate(n.block.process_tags(in_tags, lens[n.idx])):
                    tags[(n.idx, k)] = ot
        return new_states

    def _run_node(self, node: Node, values, tags, device, stream=None) -> None:
        """Run one node outside a segment: offline (``stream`` None) or one
        chunk of ``run_stream`` (``stream`` = (states, offset, n, sink
        offsets)).  Fills ``values`` and ``tags`` for its output ports."""
        b = node.block
        if isinstance(b, SourceBlock):
            if stream is None:
                out = b.apply(device)
                src_tags = b.emit_tags(0, b.total_len())
            else:
                _, offset, n, _ = stream
                out = b.emit(offset, n, device)
                src_tags = b.emit_tags(offset, n)
            outs = out if isinstance(out, tuple) else (out,)
            for k, o in enumerate(outs):
                values[(node.idx, k)] = o
                tags[(node.idx, k)] = list(src_tags)
            return
        keys = [(p.node.idx, p.index) for p in node.inputs]
        xs = [values[k] for k in keys]
        in_tags = [tags.get(k, []) for k in keys]
        if hasattr(b, "set_tags") and in_tags:
            b.set_tags(in_tags[0])
        if stream is None:
            out = b.apply(*xs)
        else:
            states = stream[0]
            states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
        if b.n_out == 0:
            if hasattr(b, "accept_tags") and in_tags:
                if stream is None:
                    b.accept_tags(in_tags[0], 0)
                else:
                    # sink-relative positions: the samples taken so far
                    seen = stream[3]
                    b.accept_tags(in_tags[0], seen.get(node.idx, 0))
                    seen[node.idx] = seen.get(node.idx, 0) + _length(xs[0])
            return
        outs = out if isinstance(out, tuple) else (out,)
        otags = b.process_tags(in_tags, [_length(o) for o in outs])
        for k, (o, ot) in enumerate(zip(outs, otags)):
            values[(node.idx, k)] = o
            tags[(node.idx, k)] = ot

    # ---- offline ----
    def run(self, device="cuda") -> None:
        """Offline mode: evaluate every block once over whole streams,
        sources emitting on ``device``: the card unless the caller names
        another.  Without a card the default raises; it never moves to the
        CPU by itself (pass ``device="cpu"`` for the kernels' plain
        versions).  Blocks with ``flush()`` drain at the end, unless the
        run was cancelled."""
        device = target_device(device, "Graph.run")
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list[Tag]] = {}
        segs = self._segments()
        for node in self._topo():
            if self._token.is_cancelled():
                break
            first = self._seg_member.get(node.idx)
            if first is not None:
                if first == node.idx:
                    self._run_segment(segs[first], values, tags)
                continue
            self._run_node(node, values, tags, device)
        if not self._token.is_cancelled():
            self._flush_pass()

    # ---- streaming ----
    def run_stream(self, chunk_size: int = 1 << 18,
                   max_chunks: int | None = None,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0,
                   resume_from: str | None = None,
                   device="cuda") -> None:
        """Streaming mode: fixed-size chunks with carried block state
        (``rustradio_tpu/graph.py:846-1105`` less its scan, mesh and
        profiler options).

        Sources emit each chunk on ``device`` (the card unless the caller
        names another; without a card the default raises).  Device
        segments run one chunk at a time through their members' chunk
        forms, FM pairs lowered to kernel B; host blocks see the chunks in
        order; tags flow through ``process_tags`` / ``set_tags`` /
        ``accept_tags`` with chunk-relative positions (sinks add what they
        took before).  A bounded stream ends at its shortest source; an
        unbounded one needs ``max_chunks``, which also bounds the chunks of
        THIS call (a pause that a later ``resume_from`` continues).  A
        source's ``exhausted()`` ends the stream early.

        With ``checkpoint_path`` and ``checkpoint_every=k`` every block's
        state, the stream offset and the blocks' ``host_state()`` are
        saved every k chunks (the JAX package's format); ``resume_from``
        restarts from such a file, which must come from a graph of the same
        blocks.  The end-of-stream drain (``flush()``, or
        ``flush_with_state(state)``) runs only at a true end of stream: a
        ``max_chunks`` or cancel pause keeps pending output in the carried
        state, so a resumed run emits it once.
        """
        device = target_device(device, "Graph.run_stream")
        sources = [n for n in self.nodes if isinstance(n.block, SourceBlock)]
        if not sources:
            raise ValueError("graph has no sources")
        totals = [s.block.total_len() for s in sources]
        if any(t is None for t in totals):
            if max_chunks is None:
                raise ValueError("unbounded source needs max_chunks")
            total = max_chunks * chunk_size
        else:
            total = min(totals)
        states = {n.idx: n.block.init_state() for n in self.nodes}
        segs = self._segments()
        offset = 0
        if resume_from is not None:
            states, offset, extra = load_checkpoint(resume_from, states, device)
            names = [n.block.name() for n in self.nodes]
            if extra.get("blocks") is not None and extra["blocks"] != names:
                raise ValueError(f"checkpoint was taken on a different graph: "
                                 f"{extra['blocks']} vs {names}")
            if extra.get("mesh"):
                raise ValueError("checkpoint of a mesh run: it carries shard "
                                 "halos, not block state")
            for n in self.nodes:
                hs = extra.get("host", {}).get(n.idx)
                if hs is not None and hasattr(n.block, "restore_host_state"):
                    n.block.restore_host_state(hs)
        chunk_count = 0
        sink_offsets: dict[int, int] = {}
        ended = False  # a true end of stream, not a max_chunks/cancel pause
        while True:
            if offset >= total:
                ended = True
                break
            if self._token.is_cancelled():
                break
            if max_chunks is not None and chunk_count >= max_chunks:
                break
            # live sources may end before their nominal bound
            if any(getattr(s.block, "exhausted", lambda: False)()
                   for s in sources):
                ended = True
                break
            n_chunk = min(chunk_size, total - offset)
            stream = (states, offset, n_chunk, sink_offsets)
            values: dict[tuple[int, int], Any] = {}
            tags: dict[tuple[int, int], list[Tag]] = {}
            for node in self._topo():
                first = self._seg_member.get(node.idx)
                if first is not None:
                    if first == node.idx:
                        states.update(self._run_segment(segs[first], values,
                                                        tags, states=states))
                    continue
                self._run_node(node, values, tags, device, stream)
            offset += n_chunk
            chunk_count += 1
            if (checkpoint_path and checkpoint_every
                    and chunk_count % checkpoint_every == 0):
                self._save_checkpoint(checkpoint_path, states, offset)
        if ended:
            self._flush_pass(states)

    def _save_checkpoint(self, path: str, states: dict, offset: int) -> None:
        """Snapshot the stream: block states, offset, and the host-side
        state of blocks that keep some outside their carried state
        (``host_state()``)."""
        save_checkpoint(path, states, offset, extra={
            "blocks": [n.block.name() for n in self.nodes],
            "mesh": False,
            "host": {n.idx: n.block.host_state() for n in self.nodes
                     if hasattr(n.block, "host_state")},
        })

    def _flush_pass(self, states=None) -> None:
        """End-of-stream drain, once after the last chunk (reference
        ``rustradio_tpu/graph.py:677-737``).

        Blocks exposing ``flush()`` emit their final outputs here (the
        reference's blocks that push on EOF, e.g. src/hasher.rs:41-49);
        ``flush_with_state(state)`` reads the carried state instead, which
        keeps the drain right across checkpoint/resume.  Drained values
        propagate through the blocks downstream, one at a time (``apply``
        offline, ``apply_chunk`` with the carried state when streaming),
        so sinks see them.  A node runs only if it flushed or all its
        inputs produced drain values."""
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list[Tag]] = {}
        # sinks count the drain's tag positions from 0
        stream = None if states is None else (states, 0, 0, {})
        for node in self._topo():
            b = node.block
            keys = [(p.node.idx, p.index) for p in node.inputs]
            if keys and all(k in values for k in keys):
                self._run_node(node, values, tags, None, stream)
            if states is not None and hasattr(b, "flush_with_state"):
                fout = b.flush_with_state(states.get(node.idx))
            else:
                fout = b.flush() if hasattr(b, "flush") else None
            if fout is None or b.n_out == 0:
                continue
            fouts = fout if isinstance(fout, tuple) else (fout,)
            merged = [_cat_outputs(values.get((node.idx, k)), f)
                      for k, f in enumerate(fouts)]
            in_tags = [tags.get(k, []) for k in keys]
            otags = b.process_tags(in_tags, [_length(o) for o in merged])
            for k, (o, ot) in enumerate(zip(merged, otags)):
                if o is not None:
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
          are reduced mod that period (any ``offset0``, past 2^31 too: the
          arithmetic is Python's);
        * no source emits tags: the loop carries none, so a source that
          gives any (``emit_tags`` over its whole pattern) is refused
          rather than its tags dropped (``run_stream`` carries them).

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
            if not isinstance(b, SourceBlock):
                continue
            per = getattr(b, "emit_period", None)
            if per is not None:
                p = per()
                if p % chunk_size:
                    raise ValueError(
                        f"{b.name()} period {p} must be a multiple of "
                        f"chunk_size for the device loop"
                    )
                periods[node.idx] = p
            src_tags = b.emit_tags(0, b.total_len() or chunk_size * n_chunks)
            if src_tags:
                raise ValueError(
                    f"{b.name()} emits tags ({sorted({t.key for t in src_tags})})"
                    f", which the device loop does not carry; use a source "
                    f"without tags or run the graph with run_stream")
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
                    offset = offset0 + index * chunk_size
                    p = periods.get(node.idx)
                    if p is not None:
                        offset %= p
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
