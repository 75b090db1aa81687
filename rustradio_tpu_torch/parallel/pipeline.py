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
ordered as the halo exchange orders them (even ranks first).  The JAX
form's ``lax.scan`` over rounds is this loop, not a kernel.

Throughput approaches one chunk per round once the pipe fills; latency is
``n_stages`` rounds.
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


def _pipe(stages, chunks: torch.Tensor, mesh, width: int) -> torch.Tensor:
    """The rounds of the pipeline over ``stages`` ((fn, in_len, out_len)
    each) on a wire of ``width`` samples of ``chunks``' dtype; returns the
    last stage's outputs, (n_chunks, out_len of the last stage), on the
    last stage's device (on every process of a mesh across processes:
    the last process sends them to the others)."""
    n_stages = len(stages)
    n_chunks = chunks.shape[0]
    dtype = chunks.dtype
    devs = mesh.devices
    first = mesh.first  # this process's first stage
    last_here = first + mesh.local - 1
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
    outs = []
    for r in range(n_chunks + n_stages - 1):
        ys = []
        for j, dv in enumerate(devs):
            d = first + j
            with on_device(dv):
                if d == 0:
                    cur = (chunks[r] if r < n_chunks
                           else chunks.new_zeros(chunks.shape[1])).to(dv)
                    cur = torch.cat([cur, cur.new_zeros(width - cur.shape[0])])
                else:
                    cur = carry[j]
                ys.append(run_stage(d, cur))
        for j in range(len(devs) - 1):
            carry[j + 1] = ys[j].to(devs[j + 1], non_blocking=True)
        if mesh.world > 1:
            got = _exchange(ys[-1] if last_here < n_stages - 1 else None,
                            mesh.rank + 1, carry[0] if first else None,
                            mesh.rank - 1, mesh.rank)
            if first:
                carry[0] = got.to(devs[0])
        if last_here == n_stages - 1 and r >= n_stages - 1:
            outs.append(ys[-1][:out_last])
    if mesh.world == 1:
        return torch.stack(outs)
    res = (torch.stack(outs) if last_here == n_stages - 1 else
           torch.zeros((n_chunks, out_last), dtype=dtype, device=devs[-1]))
    buf = _wire(res)
    dist.broadcast(buf, src=mesh.world - 1)
    return torch.view_as_complex(buf) if dtype.is_complex else buf


def pipeline_run(stage_fns, chunks, mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``chunks`` through ``stage_fns`` with stage d on the mesh's
    device d.

    ``stage_fns``: D functions, each (chunk,) -> (chunk,) of the same
    dtype.  ``chunks``: (n_chunks, chunk_len), a tensor or numpy array.
    Returns (n_chunks, chunk_len) outputs, equal to applying the composed
    stages to each chunk, on the last stage's device.
    """
    _stages_check(len(stage_fns), mesh, axis)
    chunks = _as_chunks(chunks)
    m = chunks.shape[1]
    return _pipe([(fn, m, m) for fn in stage_fns], chunks, mesh, m)


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
    return _pipe(list(stages), chunks, mesh, width)


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
