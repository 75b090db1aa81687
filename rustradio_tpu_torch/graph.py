"""Flowgraph builder and runners (port of ``rustradio_tpu/graph.py``).

A graph is a DAG evaluated in topological order, with

* ``run(device)`` — offline mode: whole streams in one pass;
* ``run_stream(chunk_size, ..., device)`` — streaming mode: fixed-size
  chunks with each block's carried state, semantically the offline
  stream, with checkpoint/resume (``utils.checkpoint``), cancellation
  (``cancel_token()``), an end-of-stream drain (``flush()``) and the
  batched runner (``scan_chunks=B``: each device unit advances a batch of
  chunks as one CUDA-graph replay on the card);
* ``compile_device_loop(chunk_size, n_chunks, device)`` — a streaming
  loop over fixed-size chunks with each block's carried state and every
  sink folding on the device, synchronising once at the end.  On a CUDA
  device the n-chunk loop is captured once into a CUDA graph and replayed
  (one submission instead of a Python dispatch per op); on the CPU it is
  the plain loop.

Maximal runs of device-domain blocks form segments; inside a segment the
FM pattern ``[FloatToComplex ->] FirFilter -> QuadratureDemod`` lowers to
one kernel B pass (``lowering.py``), offline and in every streaming
runner.  PyTorch runs eagerly, so a segment is a plain loop over its
members (recorded once into a CUDA graph by the device loop and by the
batched runner on the card).

``run`` and ``run_stream`` take ``profile_dir=``: a ``torch.profiler``
trace (CPU activity, and CUDA activity on the card) written there as a
Chrome trace, with one ``rr::<name>`` region per block, ``rr::segment:``
per segment call and ``rr::scan:`` per replayed batch.  Every run keeps
per-block seconds (CUDA events around each block on the card, read once
at the end of the run; the host's clock elsewhere) and per-block costs
for ``generate_stats()`` and ``costs()``.

``run`` and ``run_stream`` take ``mesh=`` (a ``parallel.Mesh`` of this
process's devices, its first one ``device``): every maximal run of device
blocks that declare a shard plan runs as one ``parallel.graph_mesh.
MeshSegment`` with the sample axis sharded over ``shard_axis`` (one named
axis of a 1-D or a (chan, time) mesh), the filter histories crossing shards as halos and chunks as carried tails, so
the outputs are the unsharded runner's (the reference swaps ``Graph`` for
``MTGraph``, src/mtgraph.rs:73-149).  A chunk that does not fit the mesh
(a ragged last chunk, one shorter than the halos) demotes its segment to
the unsharded path for the rest of the stream, its carried tails turned
into the members' states; ``demotions`` lists each one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
from typing import Any

import torch

from . import lowering
from ._device import target_device
from .blocks.base import Block, SourceBlock
from .ops import kernels
from .streams import Tag
from .utils.checkpoint import load_checkpoint, save_checkpoint

_MESH = "mesh:"  # the state key of a mesh segment: "mesh:<first member>"

_MAX_CAPTURES = 8  # captured CUDA graphs kept per device loop / per graph


def _length(o) -> int:
    """Samples in a stream value (a tensor, or a list of PDUs); 0 for a
    value without a length (a packed-ring chunk)."""
    if torch.is_tensor(o):
        return o.shape[0] if o.dim() else 0
    return len(o) if hasattr(o, "__len__") else 0


def _nbytes(v) -> int:
    """Bytes of the tensors in a stream value (0 for PDUs and rings)."""
    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if isinstance(v, (tuple, list)):
        return sum(_nbytes(x) for x in v if torch.is_tensor(x))
    return 0


def _cat_outputs(a, b):
    """Two outputs of the same port, one after the other (flush drain)."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, list) or isinstance(b, list):
        return list(a) + list(b)
    return torch.cat([a, b.to(a.device)])


def _stackable(v) -> bool:
    """A batch value that is, or stacks into, one (nb, ...) tensor."""
    if torch.is_tensor(v):
        return True
    return (bool(v) and all(torch.is_tensor(c) for c in v)
            and all(c.shape == v[0].shape and c.dtype == v[0].dtype for c in v))


def _stacked(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.stack(v)


# ---- block states as trees (dicts, lists, tuples; tensors and scalars)

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _signature(tree):
    """What a capture depends on: the structure, each tensor's shape,
    dtype and device, each number's type (numbers are counters that the
    replays advance), and every other leaf's value."""
    def leaf(x):
        if torch.is_tensor(x):
            return ("T", tuple(x.shape), x.dtype, str(x.device))
        if _is_number(x):
            return ("N", type(x).__name__)
        return ("V", repr(x))

    def walk(t):
        if isinstance(t, dict):
            return ("d", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        return leaf(t)

    return walk(tree)


# ---- CUDA graphs: one capture helper for the device loop and the batches

def _can_capture(device: torch.device) -> bool:
    """Whether the runners capture device work into CUDA graphs here."""
    return device.type == "cuda"


def _warm_up(device, fn):
    """Run ``fn()`` once on a side stream before a capture, so that what
    allocates, uploads or builds (kernel library, device taps, cuFFT
    plans, resident source data) happens outside it; its launches count
    apart (``kernels.recording()``).  Returns (fn's result, the record)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), kernels.recording() as record:
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out, record


@dataclasses.dataclass
class _Captured:
    """One captured CUDA graph, the tensors its capture returned (written
    again by every replay) and the launches recorded into it."""

    graph: Any
    out: Any
    record: kernels.LaunchRecord

    def replay(self):
        self.graph.replay()
        kernels.replayed(self.record)
        return self.out


def _capture(device, fn) -> _Captured:
    """Capture ``fn()`` into a CUDA graph inside ``kernels.recording()``
    (its launches count into the record, not into ``LAUNCHES``).  Nothing
    runs: the caller replays.  A capture that fails raises.

    The garbage collector runs before the capture and not during it: a
    dead graph's captures (its blocks form reference cycles) destroyed by
    a collection in the middle of a capture would invalidate it."""
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with kernels.recording() as record, torch.cuda.graph(graph):
            out = fn()
    finally:
        if enabled:
            gc.enable()
    return _Captured(graph, out, record)


class _CaptureCache(dict):
    """Captures by key; the last ``_MAX_CAPTURES`` are kept."""

    def put(self, key, value):
        if key not in self and len(self) >= _MAX_CAPTURES:
            del self[next(iter(self))]
        self[key] = value
        return value


_NOT_CAPTURABLE = object()  # a unit and signature that runs chunk by chunk


class _UnitCapture:
    """A device unit (a segment, or one device block) advanced over ``nb``
    chunks by one CUDA graph.

    The batch's inputs are staged into static ``(nb, chunk)`` buffers by a
    copy before each replay (the sources stay outside the graph); the
    members' states are static tensors that the graph reads and updates in
    place (states that are other tensors, after a ragged chunk or a
    resume, are copied in first); number leaves of a state are counters
    that each replay advances by ``nb`` times the warm-up chunk's step.
    Each replay's outputs are cloned before anything else runs.  ``lens``
    are the members' output lengths a chunk, ``chunk_cost`` the (bytes,
    flops) a chunk of its members that call no kernel, both from the
    warm-up chunk; ``log`` is its entry of ``Graph.capture_log``."""

    def __init__(self, graph: "Graph", unit, nb: int, chunk_in: dict,
                 states: dict, steps: dict, device, lens, chunk_cost, log):
        ext_in, ext_out, _, _ = graph._segment_plan(unit)
        self.nb, self.steps = nb, steps
        self.lens, self.chunk_cost, self.log = lens, chunk_cost, log
        self.static_in = {k: torch.empty((nb, *shape), dtype=dtype, device=device)
                          for k, (shape, dtype) in chunk_in.items()}
        self.static_states = {
            m.idx: _rebuild(states[m.idx], iter(
                [x.clone() if torch.is_tensor(x) else x
                 for x in _leaves(states[m.idx])]))
            for m in unit}
        frozen = dict(self.static_states)

        def body():
            st = dict(frozen)
            outs = {k: [] for k in ext_out}
            for bi in range(nb):
                vals = {k: self.static_in[k][bi] for k in ext_in}
                new, _, _ = graph._run_segment(unit, vals, None, st)
                st.update(new)
                for k in ext_out:
                    outs[k].append(vals[k])
            for idx, tree in self.static_states.items():
                for dst, src in zip(_leaves(tree), _leaves(st[idx])):
                    if torch.is_tensor(dst) and dst is not src:
                        dst.copy_(src)
            return {k: torch.stack(v) for k, v in outs.items()}

        self.captured = _capture(device, body)
        log["recorded"] = dict(self.captured.record.counts)

    def run(self, inputs: dict, states: dict) -> dict:
        """One replay over the batch ``inputs`` (a stacked tensor or a list
        of chunks per external input) from ``states``, which it advances;
        returns the external outputs stacked, each cloned."""
        for k, v in inputs.items():
            if torch.is_tensor(v):
                self.static_in[k].copy_(v)
            else:
                torch.stack(v, out=self.static_in[k])
        counters = {}
        for idx, tree in self.static_states.items():
            cur = _leaves(states[idx])
            for dst, src in zip(_leaves(tree), cur):
                if torch.is_tensor(dst) and dst is not src:
                    dst.copy_(src)
            counters[idx] = cur
        out = self.captured.replay()
        self.log["replays"] += 1
        for idx, tree in self.static_states.items():
            new = [s if torch.is_tensor(s) else
                   (c + self.nb * d if _is_number(c) else c)
                   for s, c, d in zip(_leaves(tree), counters[idx],
                                      self.steps[idx])]
            states[idx] = _rebuild(tree, iter(new))
        return {k: o.clone() for k, o in out.items()}


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


def _same_device(a, b) -> bool:
    """Whether two devices name the same one (``cuda`` is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None
                                                      else b.index)


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self._token = CancellationToken()
        self._segs: dict[int, list[Node]] | None = None
        self._seg_member: dict[int, int] = {}
        self._plans: dict[int, tuple] = {}
        # per-block seconds and costs (generate_stats, costs)
        self._stats: dict[int, float] = {}
        self._costs: dict[int, dict[str, float]] = {}
        self._cost_time: dict[int, float] = {}
        self._call_costs: dict = {}  # (node, input shapes) -> (bytes, flops)
        self._events: list | None = None  # CUDA events of a run on the card
        self._spare_events: list = []
        self._edge = None  # the event that ended the last timed block
        self._stream = None
        self._device: torch.device | None = None
        self._profiling = False
        #: the last trace ``profile_dir=`` wrote
        self.trace_path: str | None = None
        # the batched runner's captures, and what each captured
        self._unit_caps = _CaptureCache()
        #: one entry per capture of the batched runner: the unit's blocks,
        #: ``nb``, the launches of its warm-up and of its recording (both
        #: counted apart from ``kernels.LAUNCHES``) and its replays so far
        self.capture_log: list[dict] = []
        self._mesh_segcache: dict = {}
        self._mesh_mode = False
        #: the last run's demotions of mesh segments to the unsharded path:
        #: ``{"segment", "chunk", "offset", "reason"}`` each (``chunk`` is
        #: None offline)
        self.demotions: list[dict] = []

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
        self._mesh_segcache = {}
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

    # ---- timing, costs, profiling ----
    def _event(self):
        """A CUDA event recorded now on the run's stream, from the pool of
        events read before."""
        e = (self._spare_events.pop() if self._spare_events
             else torch.cuda.Event(enable_timing=True))
        e.record(self._stream)
        return e

    @contextlib.contextmanager
    def _timed(self, idxs, cost_idx=None):
        """Time the block: CUDA events on the current stream of a run on
        the card (read once, at the end of the run; a block starts at the
        event that ended the block before), the host's clock elsewhere;
        the seconds are split over ``idxs``, and the whole goes to
        ``cost_idx``'s cost time."""
        if self._events is not None:
            start = self._edge or self._event()
            yield
            self._edge = self._event()
            self._events.append((idxs, cost_idx, start, self._edge))
            return
        t0 = time.perf_counter()
        yield
        self._add_time(idxs, cost_idx, time.perf_counter() - t0)

    def _add_time(self, idxs, cost_idx, dt: float) -> None:
        for i in idxs:
            self._stats[i] = self._stats.get(i, 0.0) + dt / len(idxs)
        if cost_idx is not None:
            self._cost_time[cost_idx] = self._cost_time.get(cost_idx, 0.0) + dt

    def _settle(self) -> None:
        """Read the CUDA events of the run (one synchronise)."""
        if self._events:
            torch.cuda.synchronize(self._device)
            for idxs, cost_idx, s, e in self._events:
                self._add_time(idxs, cost_idx, s.elapsed_time(e) * 1e-3)
            self._spare_events = list({id(e): e for ev in self._events
                                       for e in ev[2:]}.values())
            self._events.clear()
        self._edge = None

    def _add_cost(self, idx: int, nbytes: float, flops: float) -> None:
        if nbytes or flops:
            c = self._costs.setdefault(idx, {"flops": 0.0, "bytes": 0.0})
            c["bytes"] += nbytes
            c["flops"] += flops

    def _costed(self, idx: int, xs, fn, chunk: bool = False):
        """``fn()`` with its cost: the kernels' work if it called any, else
        the bytes of its tensor inputs and outputs and, for a device
        block, the operations ``FlopCounterMode`` counts, both taken at
        the node's first call with these input shapes and reused (the
        counter's first use in a process imports ``torch._dynamo``, about
        2 s once).  Returns (out, (bytes, flops)) where the pair holds the
        second kind only; the kernels' work goes to the active
        accumulator (``kernels.active_work()``).  ``chunk``: ``fn`` returns
        (state, outputs), and only the outputs count."""
        acc = kernels.active_work()
        b0, f0 = acc["bytes"], acc["flops"]
        key = (idx,) + tuple(x.shape if torch.is_tensor(x) else None for x in xs)
        cost = self._call_costs.get(key)
        if cost is not None:
            out = fn()
        else:
            flops = 0.0
            if (self.nodes[idx].block.domain == "device"
                    and any(torch.is_tensor(x) for x in xs)):
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as fc:
                    out = fn()
                flops = float(fc.get_total_flops())
            else:
                out = fn()
            outs = out[1] if chunk else out
            outs = outs if isinstance(outs, tuple) else (outs,)
            cost = self._call_costs[key] = (
                float(sum(_nbytes(x) for x in xs) + sum(_nbytes(o) for o in outs)),
                flops)
        if acc["bytes"] != b0 or acc["flops"] != f0:
            return out, (0.0, 0.0)
        return out, cost

    @contextlib.contextmanager
    def _accounted(self, idx: int):
        """Adds the kernels' work done inside to ``idx``'s cost; yields a
        list for the other costs ((bytes, flops) pairs) of the region."""
        w0 = dict(kernels.WORK)
        other: list = []
        yield other
        self._add_cost(idx, kernels.WORK["bytes"] - w0["bytes"]
                       + sum(o[0] for o in other),
                       kernels.WORK["flops"] - w0["flops"]
                       + sum(o[1] for o in other))

    def _annotate(self, name: str):
        if not self._profiling:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"rr::{name}")

    @contextlib.contextmanager
    def _run_ctx(self, device: torch.device, profile_dir: str | None):
        """Around a run: the CUDA events of the block timings (read at its
        end), and the ``torch.profiler`` trace when ``profile_dir`` is set,
        written there as ``rr_trace_<ms>.json``."""
        self._device = device
        self._events = [] if device.type == "cuda" else None
        # the stream the run enqueues on, looked up once (a lookup a block
        # costs microseconds)
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._profiling = True
        try:
            yield
        finally:
            if prof is not None:
                self._profiling = False
                prof.__exit__(None, None, None)
            self._settle()
            self._events = None
        if prof is not None:
            os.makedirs(profile_dir, exist_ok=True)
            self.trace_path = os.path.join(
                profile_dir, f"rr_trace_{int(time.time() * 1e3)}.json")
            prof.export_chrome_trace(self.trace_path)

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

    def _mesh_eligible(self, n: Node) -> bool:
        """Can this block join a mesh segment?  A device block with a
        shard plan (``Block.shard_fn``) and no end-of-stream flush hook
        (the sharded form cannot reproduce a drain through padding)."""
        b = n.block
        return (self._fusable(n)
                and not hasattr(b, "flush")
                and not hasattr(b, "flush_with_state")
                and b.shard_fn(0) is not None)

    def _segments_mesh(self, mesh, shard_axis: str):
        """Mesh-mode segmentation (``rustradio_tpu/graph.py:261-331``): runs
        of device nodes split where shardability changes; a maximal run
        of mesh-eligible nodes (length >= 1) becomes a sharded segment
        with its :class:`~.parallel.graph_mesh.MeshSegment`, unless the
        plan raises ``NotShardable`` (then, like every other run of length
        >= 2, an ordinary segment).  Returns (segs, seg_member, plans),
        ``plans`` keyed by a sharded segment's first idx; cached per
        (mesh, axis)."""
        from .parallel.graph_mesh import MeshSegment, NotShardable

        key = (mesh, shard_axis)
        if key in self._mesh_segcache:
            return self._mesh_segcache[key]
        segs: dict[int, list[Node]] = {}
        plans: dict[int, Any] = {}

        def close(cur, cur_mesh):
            if cur_mesh:
                try:
                    ext_in, ext_out = self._segment_io(cur)
                    plans[cur[0].idx] = MeshSegment(cur, ext_in, ext_out, mesh,
                                                    shard_axis)
                    segs[cur[0].idx] = cur
                    return
                except NotShardable:
                    pass
            if len(cur) > 1:
                segs[cur[0].idx] = cur

        cur: list[Node] = []
        cur_mesh = False
        for n in self._topo():
            if not self._fusable(n):
                if cur:
                    close(cur, cur_mesh)
                cur = []
                continue
            m = self._mesh_eligible(n)
            if cur and m != cur_mesh:
                close(cur, cur_mesh)
                cur = []
            cur.append(n)
            cur_mesh = m
        if cur:
            close(cur, cur_mesh)
        seg_member = {m.idx: s[0].idx for s in segs.values() for m in s}
        self._mesh_segcache[key] = (segs, seg_member, plans)
        return self._mesh_segcache[key]

    def _layout(self, mesh, shard_axis: str, device):
        """(segs, seg_member, mesh plans) of a run: the mesh segmentation
        when ``mesh`` is given, else the plain one with no plans.  A mesh
        must be this process's, have an axis ``shard_axis`` and start (its
        first device in grid order) at ``device``."""
        if mesh is None:
            return self._segments(), self._seg_member, {}
        mesh.axis_index(shard_axis)
        if mesh.world > 1:
            raise ValueError("the Graph runners take a mesh of one process's "
                             "devices; a mesh across processes runs "
                             "parallel.graph_mesh.MeshSegment directly")
        if not _same_device(mesh.devices[0], device):
            raise ValueError(f"the mesh starts on {mesh.devices[0]}, the run is "
                             f"on {device}: pass device= the mesh's first device")
        return self._segments_mesh(mesh, shard_axis)

    def _demote(self, seg, chunk, offset: int, reason: str) -> None:
        self.demotions.append({"segment": self._unit_name(seg), "chunk": chunk,
                               "offset": offset, "reason": reason})

    def _run_segment_mesh(self, ms, seg, values, tags, mesh_state=None,
                          true_len=None) -> dict:
        """One chunk of a mesh segment (``rustradio_tpu/graph.py:596-636``),
        timed, traced (``rr::mesh:<name>``) and costed like a segment.

        ``mesh_state`` — ``{"tails": carries, "consumed": int}`` carried
        across chunks; None offline (zero history, the whole stream one
        chunk).  ``true_len`` — the unpadded input length when this call
        ends the stream (its end trims); None mid-stream.  Returns the new
        mesh state."""
        x = values[ms.ext_in]
        n = _length(x)
        if mesh_state is None or mesh_state.get("tails") is None:
            mesh_state = {"tails": ms.init_carries(x), "consumed": 0}
        consumed = int(mesh_state["consumed"])
        w0 = dict(kernels.WORK)
        with self._accounted(seg[0].idx) as other, \
                self._timed([m.idx for m in seg], seg[0].idx), \
                self._annotate(f"mesh:{self._unit_name(seg)}"):
            tails, outs, _ = ms.run_chunk(mesh_state["tails"], x, consumed,
                                          true_len=true_len)
            if kernels.WORK == w0:  # no kernel: the bytes in and out
                other.append((float(_nbytes(x) + _nbytes(outs)), 0.0))
        for k, o in zip(ms.ext_out, outs):
            values[k] = o
        n_true = true_len if true_len is not None else n
        self._segment_tags(seg, tags, ms.member_lens(consumed, n_true))
        return {"tails": tails, "consumed": consumed + n_true}

    @staticmethod
    def _unit_name(unit) -> str:
        return "+".join(n.block.name() for n in unit[:3]) + (
            f"+{len(unit) - 3}" if len(unit) > 3 else "")

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
        """(ext_in, ext_out, fm plans, consumed idxs) of a segment (or of
        one device block, the batched runner's unit of one), cached."""
        key = tuple(n.idx for n in seg)
        if key not in self._plans:
            ext_in, ext_out = self._segment_io(seg)
            plans, consumed = lowering.find_fm_pairs(seg, set(ext_out))
            self._plans[key] = (ext_in, ext_out, plans, consumed)
        return self._plans[key]

    def _run_segment(self, seg, values, tags=None, states=None):
        """Execute a segment, FM pairs lowered.  Offline when ``states`` is
        None, else one chunk of the streaming form; maps ``tags`` (when
        given) through every member.  Reads its external inputs from
        ``values`` and writes its external outputs there.  Returns the
        members' new states, their output lengths, and the (bytes, flops)
        of the members that called no kernel."""
        ext_in, ext_out, plans, consumed = self._segment_plan(seg)
        vals = {k: values[k] for k in ext_in}
        lens: dict[int, list[int]] = {}
        new_states: dict[int, Any] = {}
        other = [0.0, 0.0]
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
                out, cost = self._costed(n.idx, xs, lambda: n.block.apply(*xs))
            else:
                (new_states[n.idx], out), cost = self._costed(
                    n.idx, xs, lambda: n.block.apply_chunk(states[n.idx], *xs),
                    chunk=True)
            other[0] += cost[0]
            other[1] += cost[1]
            outs = out if isinstance(out, tuple) else (out,)
            for k, o in enumerate(outs):
                vals[(n.idx, k)] = o
            lens[n.idx] = [_length(o) for o in outs]
        for key in ext_out:
            values[key] = vals[key]
        if tags is not None:
            self._segment_tags(seg, tags, lens)
        return new_states, lens, tuple(other)

    @staticmethod
    def _segment_tags(seg, tags, lens) -> None:
        """Map ``tags`` through every member of ``seg``, whose output
        lengths are ``lens``."""
        for n in seg:
            in_tags = [tags.get((p.node.idx, p.index), []) for p in n.inputs]
            for k, ot in enumerate(n.block.process_tags(in_tags, lens[n.idx])):
                tags[(n.idx, k)] = ot

    def _exec_unit(self, unit, values, tags, states=None):
        """One call of a segment (or of one device block), timed, traced
        and costed: the whole on the first member, as the JAX package
        reports a fused program.  Returns the members' new states."""
        name = (f"segment:{self._unit_name(unit)}" if len(unit) > 1
                else unit[0].block.name())
        with self._accounted(unit[0].idx) as other, \
                self._timed([m.idx for m in unit], unit[0].idx), \
                self._annotate(name):
            new_states, _, cost = self._run_segment(unit, values, tags, states)
            other.append(cost)
        return new_states

    def _run_node(self, node: Node, values, tags, device, stream=None) -> None:
        """Run one node outside a segment: offline (``stream`` None) or one
        chunk of ``run_stream`` (``stream`` = (states, offset, n, sink
        offsets)).  Fills ``values`` and ``tags`` for its output ports."""
        b = node.block
        if isinstance(b, SourceBlock):
            with self._timed([node.idx]), self._annotate(b.name()):
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
        with self._accounted(node.idx) as other, \
                self._timed([node.idx], node.idx), self._annotate(b.name()):
            if stream is None:
                out, cost = self._costed(node.idx, xs, lambda: b.apply(*xs))
            else:
                states = stream[0]
                (states[node.idx], out), cost = self._costed(
                    node.idx, xs, lambda: b.apply_chunk(states[node.idx], *xs),
                    chunk=True)
            other.append(cost)
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

    def _finish(self) -> None:
        """Notify the blocks that end a run (``finish()``: canaries, file
        and audio sinks), as the JAX package's runners do."""
        for node in self.nodes:
            if hasattr(node.block, "finish"):
                node.block.finish()

    # ---- offline ----
    def run(self, device="cuda", profile_dir: str | None = None, mesh=None,
            shard_axis: str = "time") -> None:
        """Offline mode: evaluate every block once over whole streams,
        sources emitting on ``device``: the card unless the caller names
        another.  Without a card the default raises; it never moves to the
        CPU by itself (pass ``device="cpu"`` for the kernels' plain
        versions).  Blocks with ``flush()`` drain at the end, unless the
        run was cancelled; then every block's ``finish()`` runs.
        ``profile_dir`` writes a ``torch.profiler`` trace there.

        ``mesh``: a ``parallel.Mesh`` whose first device is ``device``
        (else ValueError) — each run of device blocks that declare shard
        plans executes as one mesh segment with the sample axis sharded
        over ``shard_axis`` (on a (chan, time) mesh, on every line along
        that axis, replicated along the other: the run on a 1-D mesh of
        ``mesh.shape[shard_axis]`` shards; an axis the mesh lacks raises);
        the outputs are the single-device run's.  A
        stream shorter than a segment's halos runs that segment unsharded
        (recorded in ``demotions``)."""
        device = target_device(device, "Graph.run")
        segs, seg_member, plans = self._layout(mesh, shard_axis, device)
        self.demotions = []
        with self._run_ctx(device, profile_dir):
            values: dict[tuple[int, int], Any] = {}
            tags: dict[tuple[int, int], list[Tag]] = {}
            for node in self._topo():
                if self._token.is_cancelled():
                    break
                first = seg_member.get(node.idx)
                if first is not None:
                    if first != node.idx:
                        continue
                    ms = plans.get(first)
                    if ms is not None:
                        n_in = _length(values[ms.ext_in])
                        if n_in >= ms.min_chunk:
                            self._run_segment_mesh(ms, segs[first], values, tags,
                                                   true_len=n_in)
                            continue
                        self._demote(segs[first], None, 0,
                                     f"stream of {n_in} shorter than the "
                                     f"halos' {ms.min_chunk}")
                    self._exec_unit(segs[first], values, tags)
                    continue
                self._run_node(node, values, tags, device)
            if not self._token.is_cancelled():
                self._flush_pass()
        self._finish()

    # ---- streaming ----
    def run_stream(self, chunk_size: int = 1 << 18,
                   max_chunks: int | None = None,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0,
                   resume_from: str | None = None,
                   device="cuda",
                   profile_dir: str | None = None,
                   scan_chunks: int | None = None,
                   mesh=None,
                   shard_axis: str = "time") -> None:
        """Streaming mode: fixed-size chunks with carried block state
        (``rustradio_tpu/graph.py:846-1105``).

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

        ``scan_chunks=B`` batches the stream (the JAX package's compiled
        streaming runner): after the call's first chunk, which runs alone,
        whole batches of ``nb = min(B, full chunks left, max_chunks left)``
        chunks run whenever nb >= 2, and a ragged last chunk runs alone.
        Host blocks see a batch's chunks one at a time, in order, with
        their own tags; a source with ``emit_batch(offset, chunk, nb,
        device)`` gives a batch in one call, an n_out == 0 block with
        ``accept_batch(*stacked)`` (and no ``accept_tags``) takes one.
        Each device unit (a segment, or one device block) advances the
        batch as one: on a CUDA device as ONE replay of a CUDA graph
        captured per (unit, nb, shapes) when every member declares
        ``graph_capturable``, its inputs are tensors of one shape, and a
        warm-up chunk on copies of its states shows them keeping their
        shapes and dtypes; otherwise (and on the CPU) chunk by chunk.
        ``capture_log`` says what was captured.

        With ``checkpoint_path`` and ``checkpoint_every=k`` every block's
        state, the stream offset and the blocks' ``host_state()`` are
        saved every k chunks (the JAX package's format; under
        ``scan_chunks`` when a batch crosses a multiple of k, as there);
        ``resume_from`` restarts from such a file, which must come from a
        graph of the same blocks.  The end-of-stream drain (``flush()``, or
        ``flush_with_state(state)``) runs only at a true end of stream: a
        ``max_chunks`` or cancel pause keeps pending output in the carried
        state, so a resumed run emits it once.  Every block's ``finish()``
        runs at the end.  ``profile_dir`` writes a ``torch.profiler``
        trace there.

        ``mesh=`` shards every mesh segment's sample axis over
        ``shard_axis`` (see :meth:`run`); its tails carry from chunk to
        chunk (``MeshSegment.run_chunk``), and under ``scan_chunks`` a
        batch advances through ``MeshSegment.run_batch``.  A chunk that
        does not fit the mesh (length not a multiple of ``n_sh * div``, or
        shorter than the halos: a ragged last chunk) demotes its segment
        one way: the carried tails become the members' streaming states
        and the unsharded path runs it from then on, outputs exact; each
        demotion is recorded in ``demotions``.  A checkpoint of a mesh run
        holds each segment's tails and count (``"mesh:<first idx>"``, the
        JAX package's keys) and resumes only with a mesh; a plain one only
        without.
        """
        device = target_device(device, "Graph.run_stream")
        layout = self._layout(mesh, shard_axis, device)
        self.demotions = []
        self._mesh_mode = mesh is not None
        with self._run_ctx(device, profile_dir):
            self._run_stream_inner(chunk_size, max_chunks, checkpoint_path,
                                   checkpoint_every, resume_from, device,
                                   scan_chunks, layout)
        self._finish()

    def _run_stream_inner(self, chunk_size, max_chunks, checkpoint_path,
                          checkpoint_every, resume_from, device,
                          scan_chunks, layout) -> None:
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
        segs, seg_member, plans = layout
        offset = 0
        if resume_from is not None:
            states, offset, extra = load_checkpoint(resume_from, states, device)
            names = [n.block.name() for n in self.nodes]
            if extra.get("blocks") is not None and extra["blocks"] != names:
                raise ValueError(f"checkpoint was taken on a different graph: "
                                 f"{extra['blocks']} vs {names}")
            if bool(extra.get("mesh", False)) != self._mesh_mode:
                raise ValueError(
                    "checkpoint mesh mode differs from this run's: a mesh "
                    "checkpoint carries shard halos, not block state")
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
            nb = 0
            if scan_chunks and scan_chunks > 1 and chunk_count >= 1:
                nb = min(scan_chunks, (total - offset) // chunk_size)
                if max_chunks is not None:
                    nb = min(nb, max_chunks - chunk_count)
            if nb >= 2:
                self._run_batch(nb, chunk_size, offset, states, sink_offsets,
                                device, layout, chunk_count)
                before = chunk_count
                offset += nb * chunk_size
                chunk_count += nb
                if (checkpoint_path and checkpoint_every
                        and before // checkpoint_every
                        != chunk_count // checkpoint_every):
                    self._save_checkpoint(checkpoint_path, states, offset)
                continue
            n_chunk = min(chunk_size, total - offset)
            stream = (states, offset, n_chunk, sink_offsets)
            values: dict[tuple[int, int], Any] = {}
            tags: dict[tuple[int, int], list[Tag]] = {}
            for node in self._topo():
                first = seg_member.get(node.idx)
                if first is not None:
                    if first != node.idx:
                        continue
                    ms = plans.get(first)
                    if ms is not None and self._mesh_chunk(
                            ms, segs[first], values, tags, states, chunk_count,
                            offset):
                        continue
                    states.update(self._exec_unit(segs[first], values, tags,
                                                  states))
                    continue
                self._run_node(node, values, tags, device, stream)
            offset += n_chunk
            chunk_count += 1
            if (checkpoint_path and checkpoint_every
                    and chunk_count % checkpoint_every == 0):
                self._save_checkpoint(checkpoint_path, states, offset)
        if ended:
            # mesh segments: carried tails -> the members' streaming states,
            # so that drained values pass through them exactly
            for first, ms in plans.items():
                mst = states.get(f"{_MESH}{first}")
                if mst and mst.get("tails") is not None:
                    states.update(ms.carries_to_states(mst["tails"],
                                                       int(mst["consumed"])))
            self._flush_pass(states)

    def _mesh_chunk(self, ms, seg, values, tags, states, chunk: int,
                    offset: int) -> bool:
        """One chunk of a mesh segment on the mesh, if it still runs there
        and the chunk fits (a multiple of ``n_sh * div``, no shorter than
        the halos); else demote it — its tails to the members' states, for
        good — and return False for the unsharded path."""
        key = f"{_MESH}{seg[0].idx}"
        mst = states.get(key)
        if isinstance(mst, dict) and mst.get("demoted"):
            return False
        n_in = _length(values[ms.ext_in])
        if n_in % (ms.n_sh * ms.div) == 0 and n_in >= ms.min_chunk:
            states[key] = self._run_segment_mesh(ms, seg, values, tags,
                                                 mesh_state=mst)
            return True
        self._demote_states(ms, seg, states, chunk, offset,
                            f"chunk of {n_in} does not fit the mesh "
                            f"(multiple of {ms.n_sh * ms.div}, at least "
                            f"{ms.min_chunk})")
        return False

    def _demote_states(self, ms, seg, states, chunk, offset, reason) -> None:
        """One-way demotion of a mesh segment in a stream: its carried
        tails become the members' streaming states."""
        key = f"{_MESH}{seg[0].idx}"
        mst = states.get(key)
        if mst and mst.get("tails") is not None:
            states.update(ms.carries_to_states(mst["tails"], int(mst["consumed"])))
        states[key] = {"demoted": True}
        self._demote(seg, chunk, offset, reason)

    # ---- the batched runner ----
    def _run_batch(self, nb: int, chunk_size: int, offset: int, states: dict,
                   sink_offsets: dict, device, layout, chunk: int) -> None:
        """Advance the whole graph by ``nb`` full chunks
        (``rustradio_tpu/graph.py:1176-1523``): each device unit as one
        (``_run_unit_batch``; a mesh segment through ``_mesh_batch``),
        every other block one chunk at a time in stream order.  A value is
        a stacked ``(nb, ...)`` tensor or a list of the chunks' values;
        tags are lists of the chunks' tags."""
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list] = {}
        segs, seg_member, plans = layout
        for node in self._topo():
            b = node.block
            first = seg_member.get(node.idx)
            if first is not None and first != node.idx:
                continue
            if first is not None or self._fusable(node):
                unit = segs[first] if first is not None else [node]
                ms = plans.get(first)
                if ms is not None and self._mesh_batch(
                        ms, unit, nb, values, tags, states, chunk, offset):
                    continue
                self._run_unit_batch(unit, nb, values, tags, states, device)
                continue
            keys = [(p.node.idx, p.index) for p in node.inputs]
            if isinstance(b, SourceBlock):
                offs = [offset + bi * chunk_size for bi in range(nb)]
                with self._timed([node.idx]), self._annotate(b.name()):
                    if hasattr(b, "emit_batch"):
                        values[(node.idx, 0)] = b.emit_batch(offset, chunk_size,
                                                             nb, device)
                    else:
                        per = [b.emit(o, chunk_size, device) for o in offs]
                        for k in range(max(b.n_out, 1)):
                            values[(node.idx, k)] = [
                                c[k] if isinstance(c, tuple) else c for c in per]
                src_tags = [b.emit_tags(o, chunk_size) for o in offs]
                for k in range(max(b.n_out, 1)):
                    tags[(node.idx, k)] = [list(t) for t in src_tags]
                continue
            if (b.n_out == 0 and hasattr(b, "accept_batch")
                    and not hasattr(b, "accept_tags")
                    and all(_stackable(values[k]) for k in keys)):
                with self._timed([node.idx]), self._annotate(b.name()):
                    b.accept_batch(*[_stacked(values[k]) for k in keys])
                continue
            outs = {(node.idx, k): [] for k in range(b.n_out)}
            out_tags = {(node.idx, k): [] for k in range(b.n_out)}
            for bi in range(nb):
                vals = {k: values[k][bi] for k in keys}
                tg = {k: tags[k][bi] for k in keys if k in tags}
                self._run_node(node, vals, tg, device,
                               (states, offset + bi * chunk_size, chunk_size,
                                sink_offsets))
                for k in outs:
                    outs[k].append(vals[k])
                    out_tags[k].append(tg.get(k, []))
            values.update(outs)
            tags.update(out_tags)

    def _mesh_batch(self, ms, seg, nb, values, tags, states, chunk: int,
                    offset: int) -> bool:
        """A batch of a mesh segment through ``MeshSegment.run_batch``
        (timed, traced and costed as one), with each chunk's tags mapped
        on its own member lens.  A segment that is demoted, or not warm,
        returns False for the unsharded path; ``NotShardable`` (chunks
        that do not fit the mesh) demotes it first."""
        from .parallel.graph_mesh import NotShardable

        key = f"{_MESH}{seg[0].idx}"
        mst = states.get(key)
        if (not isinstance(mst, dict) or mst.get("demoted")
                or mst.get("tails") is None):
            return False
        xs = values[ms.ext_in]
        consumed = int(mst["consumed"])
        w0 = dict(kernels.WORK)
        try:
            if not _stackable(xs):
                raise NotShardable("batch chunks of different shapes")
            with self._accounted(seg[0].idx) as other, \
                    self._timed([m.idx for m in seg], seg[0].idx), \
                    self._annotate(f"mesh:{self._unit_name(seg)}"):
                tails, outs, _ = ms.run_batch(mst["tails"], xs, consumed)
                if kernels.WORK == w0:
                    other.append((float(_nbytes(xs) + _nbytes(outs)), 0.0))
        except NotShardable as e:
            self._demote_states(ms, seg, states, chunk, offset, f"batch: {e}")
            return False
        n = _length(xs[0])
        states[key] = {"tails": tails, "consumed": consumed + nb * n}
        for k, o in zip(ms.ext_out, outs):
            values[k] = o
        member_tags = {(m.idx, k): [] for m in seg for k in range(m.block.n_out)}
        for bi in range(nb):
            tg = {ms.ext_in: tags[ms.ext_in][bi]} if ms.ext_in in tags else {}
            self._segment_tags(seg, tg, ms.member_lens(consumed + bi * n, n))
            for k in member_tags:
                member_tags[k].append(tg.get(k, []))
        tags.update(member_tags)
        return True

    def _run_unit_batch(self, unit, nb, values, tags, states, device) -> None:
        ext_in, ext_out, _, _ = self._segment_plan(unit)
        cap = None
        if _can_capture(device) and all(m.block.graph_capturable for m in unit):
            cap = self._unit_capture(unit, nb, values, states, device)
        if cap is None:
            # chunk by chunk, inside the batch
            collected = {k: [] for k in ext_out}
            member_tags = {(m.idx, k): [] for m in unit
                           for k in range(m.block.n_out)}
            for bi in range(nb):
                vals = {k: values[k][bi] for k in ext_in}
                tg = {k: tags[k][bi] for k in ext_in if k in tags}
                states.update(self._exec_unit(unit, vals, tg, states))
                for k in ext_out:
                    collected[k].append(vals[k])
                for k in member_tags:
                    member_tags[k].append(tg.get(k, []))
            values.update(collected)
            tags.update(member_tags)
            return
        with self._accounted(unit[0].idx) as other, \
                self._timed([m.idx for m in unit], unit[0].idx), \
                self._annotate(f"scan:{self._unit_name(unit)}"):
            values.update(cap.run({k: values[k] for k in ext_in}, states))
            other.append(tuple(nb * c for c in cap.chunk_cost))
        # tags per chunk on the lengths the warm-up chunk showed
        member_tags = {(m.idx, k): [] for m in unit for k in range(m.block.n_out)}
        for bi in range(nb):
            tg = {k: tags[k][bi] for k in ext_in if k in tags}
            self._segment_tags(unit, tg, cap.lens)
            for k in member_tags:
                member_tags[k].append(tg.get(k, []))
        tags.update(member_tags)

    def _unit_capture(self, unit, nb, values, states, device):
        """The :class:`_UnitCapture` of ``unit`` over ``nb`` chunks from
        these inputs and states, made on first use; None when the unit runs
        chunk by chunk.  Decided before anything is
        captured: the inputs must be tensors of one shape and dtype, and a
        warm-up chunk on copies of the states must leave every state's
        structure, shapes and dtypes as they were."""
        ext_in, _, _, _ = self._segment_plan(unit)
        chunk_in = {}
        for k in ext_in:
            v = values[k]
            if not _stackable(v):
                return None
            chunk_in[k] = (tuple(v[0].shape), v[0].dtype)
        st = {m.idx: states[m.idx] for m in unit}
        key = (tuple(m.idx for m in unit), nb,
               tuple(sorted(chunk_in.items(), key=str)), _signature(st))
        hit = self._unit_caps.get(key)
        if hit is _NOT_CAPTURABLE:
            return None
        if hit is not None:
            return hit
        clones = {idx: _rebuild(t, iter([x.clone() if torch.is_tensor(x) else x
                                         for x in _leaves(t)]))
                  for idx, t in st.items()}
        first = {k: values[k][0] for k in ext_in}

        def warm():
            return self._run_segment(unit, dict(first), None, clones)

        (new, lens, cost), warm_rec = _warm_up(device, warm)
        self._edge = None  # the next block's time starts after the capture
        after = {idx: new.get(idx, clones[idx]) for idx in st}
        if _signature(after) != _signature(st):
            self._unit_caps.put(key, _NOT_CAPTURABLE)
            return None
        steps = {idx: [(a - b) if _is_number(b) else None
                       for a, b in zip(_leaves(after[idx]), _leaves(st[idx]))]
                 for idx in st}
        log = {"unit": self._unit_name(unit), "nb": nb,
               "warm_up": dict(warm_rec.counts), "recorded": {}, "replays": 0}
        entry = _UnitCapture(self, unit, nb, chunk_in, states, steps, device,
                             lens, cost, log)
        self.capture_log.append(log)
        return self._unit_caps.put(key, entry)

    def _save_checkpoint(self, path: str, states: dict, offset: int) -> None:
        """Snapshot the stream: block states, offset, and the host-side
        state of blocks that keep some outside their carried state
        (``host_state()``)."""
        save_checkpoint(path, states, offset, extra={
            "blocks": [n.block.name() for n in self.nodes],
            "mesh": self._mesh_mode,
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
        so every replay starts clean.  The warm-up and the capture run
        inside ``kernels.recording()``, which counts their launches apart
        (the capture's record keeps its device taps alive);
        ``kernels.replayed`` adds the record to ``kernels.LAUNCHES`` after
        each replay.  Blocks and folds must not wait for the device or
        read a value back.

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
                                                        states=states)[0])
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

        if not _can_capture(device) or not cuda_graph:
            return fn

        source_idxs = [n.idx for n in self.nodes
                       if isinstance(n.block, SourceBlock)]
        # offset0 reduced by the periods -> its capture
        captures = _CaptureCache()

        def replay_fn(offset0: int = 0):
            check(offset0)
            key = tuple(offset0 % periods[i] if i in periods else offset0
                        for i in source_idxs)
            with torch.cuda.device(device):
                entry = captures.get(key)
                if entry is None:
                    _warm_up(device, lambda: run_loop(offset0))
                    entry = captures.put(
                        key, _capture(device, lambda: run_loop(offset0)))
                out = {idx: c.clone() for idx, c in entry.replay().items()}
                torch.cuda.synchronize(device)
            return out

        return replay_fn

    # ---- stats ----
    def generate_stats(self) -> str:
        """Per-block time table (reference src/graph.rs:175-257) with, where
        costs exist, the GFLOP, GB, GB/s and roof% columns: the port's own
        count of the work (``costs()``) over the block's time, against the
        card's device memory rate (``utils.stats``; "-" where none is
        known, as on the CPU).  A segment's time is split over its
        members; its costs and its GB/s sit on the first member, over the
        segment's whole time."""
        from .utils.stats import device_hbm_gbps

        self._settle()
        total = sum(self._stats.values()) or 1e-12
        have_costs = bool(self._costs)
        hdr = "block                          seconds     %"
        if have_costs:
            hdr += "    GFLOP     GB   GB/s  roof%"
        lines = [hdr]
        dev = self._device
        roof = device_hbm_gbps(dev) if dev is not None and dev.type == "cuda" \
            else None
        for node in self.nodes:
            t = self._stats.get(node.idx, 0.0)
            row = f"{node.block.name():<30} {t:>8.4f} {100.0 * t / total:>5.1f}"
            c = self._costs.get(node.idx)
            if c is not None:
                gbps = c["bytes"] / max(self._cost_time.get(node.idx, t), 1e-12) / 1e9
                share = f"{100 * gbps / roof:>6.1f}" if roof else f"{'-':>6}"
                row += (f" {c['flops'] / 1e9:>8.3f} {c['bytes'] / 1e9:>6.3f}"
                        f" {gbps:>6.1f}{share}")
            lines.append(row)
        lines.append(f"{'TOTAL':<30} {total:>8.4f} 100.0")
        return "\n".join(lines)

    def costs(self) -> dict[int, dict[str, float]]:
        """Per-node ``{'flops', 'bytes'}`` summed over its calls.  The port
        has no compiler cost analysis; this is its own count: a call that
        reaches kernels A-E counts their work as the wrappers compute it
        from each call's shapes (``kernels.*_work``, the count that
        ``chip_smoke.py``'s bounds read; a replayed CUDA graph counts its
        record's), any other call the bytes of its tensor inputs and
        outputs and the operations that
        ``torch.utils.flop_counter.FlopCounterMode`` counts in it (0 where
        it counts none).  A segment's costs sit on its first member."""
        self._settle()
        return {idx: dict(c) for idx, c in self._costs.items()}
