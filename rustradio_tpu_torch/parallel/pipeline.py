"""Explicit pipeline parallelism: one stage per device (port of
``rustradio_tpu/parallel/pipeline.py``).

The reference's MTGraph runs every block on its own OS thread with stream
buffers between them (src/mtgraph.rs:76-130).  Here stage d runs on the
mesh's device d, and a chunk hands off to the next stage's device once a
round — software pipelining, one chunk in flight per stage.  One host loop
drives the rounds: in round r every stage works on what it was handed in
round r-1 (stage 0 on chunk r), each on its own device's current stream,
so on several cards the stages' work overlaps.  A hand-off is a ``.to()``
within a process; where the next stage lives in another process of a
mesh across processes (``init_distributed``), a ``send`` and a ``recv``
ordered as the halo exchange orders them (even runs along the line
first).  The JAX form's ``lax.scan`` over rounds is this loop, not a
kernel.

Throughput approaches one chunk per round once the pipe fills; latency is
``n_stages`` rounds.  On a mesh of several axes the stages run along the
named axis on every line of the mesh along it (``Mesh.lines``), the
chunks replicated along the other axes, and the call returns the line
through the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .halo import _exchange, _wire
from .mesh import on_device


def _stages_check(n_stages: int, mesh, axis: str) -> None:
    if mesh.shape[axis] != n_stages:
        raise ValueError(f"mesh axis {axis} must have {n_stages} devices")


def _as_chunks(chunks) -> torch.Tensor:
    t = chunks if torch.is_tensor(chunks) else torch.from_numpy(
        np.ascontiguousarray(chunks))
    if t.dim() != 2:
        raise ValueError(f"chunks must be (n_chunks, chunk_len), got "
                         f"{tuple(t.shape)}")
    return t


def _pipe(stages, chunks: torch.Tensor, mesh, axis: str,
          width: int) -> torch.Tensor:
    """The rounds of the pipeline over ``stages`` ((fn, in_len, out_len)
    each) on a wire of ``width`` samples of ``chunks``' dtype, on every
    line of the mesh along ``axis`` (stage d on the line's shard d);
    returns the last stage's outputs, (n_chunks, out_len of the last
    stage), on the home line's last device (on every process of a mesh
    whose axis crosses processes: the process holding line 0's last stage
    sends them to the others)."""
    n_stages = len(stages)
    n_chunks = chunks.shape[0]
    dtype = chunks.dtype
    devs = mesh.devices
    lines = mesh.lines(axis)
    out_last = stages[-1][2]

    def run_stage(d, buf):
        fn, in_len, out_len = stages[d]
        y = torch.as_tensor(fn(buf[:in_len])).to(buf.dtype)
        if y.shape != (out_len,):
            raise ValueError(f"stage {d} emitted {tuple(y.shape)}, not "
                             f"({out_len},)")
        return torch.cat([y, y.new_zeros(width - out_len)]) if width > out_len else y

    # what each local stage was handed in the round before
    carry = [torch.zeros(width, dtype=dtype, device=dv) for dv in devs]
    outs = {ln.index: [] for ln in lines if ln.next is None}
    for r in range(n_chunks + n_stages - 1):
        for ln in lines:
            ys = []
            for j, d in zip(ln.local, ln.ks):
                dv = devs[j]
                with on_device(dv):
                    if d == 0:
                        cur = (chunks[r] if r < n_chunks
                               else chunks.new_zeros(chunks.shape[1])).to(dv)
                        cur = torch.cat([cur, cur.new_zeros(width - cur.shape[0])])
                    else:
                        cur = carry[j]
                    ys.append(run_stage(d, cur))
            for y, j in zip(ys[:-1], ln.local[1:]):
                carry[j] = y.to(devs[j], non_blocking=True)
            if ln.prev is not None or ln.next is not None:
                got = _exchange(None if ln.next is None else ys[-1], ln.next,
                                None if ln.prev is None else carry[ln.local[0]],
                                ln.prev, ln.seg)
                if ln.prev is not None:
                    carry[ln.local[0]] = got.to(devs[ln.local[0]])
            if ln.next is None and r >= n_stages - 1:
                outs[ln.index].append(ys[-1][:out_last])
    mesh.record(torch.stack(o).to(devs[0]) for o in outs.values())
    if not mesh.crosses(axis):
        return torch.stack(outs[mesh.home(axis).index])
    src = mesh.end_owner(axis)
    res = (torch.stack(outs[0]) if mesh.rank == src else
           torch.zeros((n_chunks, out_last), dtype=dtype,
                       device=devs[mesh.home(axis).local[-1]]))
    buf = _wire(res)
    dist.broadcast(buf, src=src)
    return torch.view_as_complex(buf) if dtype.is_complex else buf


def pipeline_run(stage_fns, chunks, mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``chunks`` through ``stage_fns`` with stage d on the mesh's
    shard d along ``axis``.

    ``stage_fns``: D functions, each (chunk,) -> (chunk,) of the same
    dtype.  ``chunks``: (n_chunks, chunk_len), a tensor or numpy array.
    Returns (n_chunks, chunk_len) outputs, equal to applying the composed
    stages to each chunk, on the last stage's device.
    """
    _stages_check(len(stage_fns), mesh, axis)
    chunks = _as_chunks(chunks)
    m = chunks.shape[1]
    return _pipe([(fn, m, m) for fn in stage_fns], chunks, mesh, axis, m)


def pipeline_run_rates(stages, chunks, mesh, axis: str = "stage") -> torch.Tensor:
    """Pipeline with static per-stage rate ratios (decimators welcome).

    ``stages``: list of ``(fn, in_len, out_len)`` — stage d maps an
    ``(in_len,)`` tensor to an ``(out_len,)`` tensor, with
    ``out_len[d] == in_len[d+1]``.  Every hand-off rides a wire of one
    width (the largest of all lens, padded with zeros) and each stage
    takes its prefix: the function's contract, kept from the JAX form, so
    that a decimating filter -> demod chain runs stage per device (the
    reference's thread-per-block MTGraph with rate-changing blocks,
    src/mtgraph.rs:73-149).

    ``chunks``: (n_chunks, in_len of stage 0) of the wire dtype (complex64
    for a complex chain; a real stage casts to it).  Returns (n_chunks,
    out_len of the last stage), equal to composing the stages chunk by
    chunk, on the last stage's device.
    """
    d_stages = len(stages)
    _stages_check(d_stages, mesh, axis)
    for d in range(d_stages - 1):
        if stages[d][2] != stages[d + 1][1]:
            raise ValueError(
                f"stage {d} emits {stages[d][2]} but stage {d + 1} takes "
                f"{stages[d + 1][1]}")
    chunks = _as_chunks(chunks)
    if chunks.shape[1] != stages[0][1]:
        raise ValueError("chunks must be (n, in_len of stage 0)")
    width = max(max(i, o) for _, i, o in stages)
    return _pipe(list(stages), chunks, mesh, axis, width)


def pipeline_chain(stage_fns, x, mesh, chunk_len: int,
                   axis: str = "stage") -> torch.Tensor:
    """Split a 1-D stream into chunks, pipeline, reassemble.  The stream's
    length must be a multiple of ``chunk_len`` and every stage chunk-local
    (elementwise, or free of carried state)."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if x.shape[0] % chunk_len:
        raise ValueError("stream length must be a multiple of chunk_len")
    return pipeline_run(stage_fns, x.reshape(-1, chunk_len), mesh,
                        axis).reshape(-1)
