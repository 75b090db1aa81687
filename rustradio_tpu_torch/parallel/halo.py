"""Halo exchange between time-adjacent shards (port of
``rustradio_tpu/parallel/halo.py``).

The reference carries per-block overlap state across work() calls
(src/fft_filter.rs:336-348 tail, src/fir.rs:493-505 lookahead); with the
time axis sharded, the same samples move between neighbours.  JAX calls
these inside ``shard_map`` on one traced shard; the port has no traced
axis, so each takes the list of this process's shards (one per mesh
device) and the mesh, and returns the extended shards.  The exchange runs
along the named axis within each line of the mesh along it, so on a
(chan, time) mesh every replica line exchanges its own halos.  A
neighbour's slice moves with
``.to(device, non_blocking=True)`` (a peer copy between cards, a
device-local copy on one card); where the neighbour lives in another
process, through ``torch.distributed``'s point-to-point ``send`` /
``recv`` — only the shards at a process boundary take that path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _check(shards, halo: int) -> None:
    if halo > min(s.shape[0] for s in shards):
        raise ValueError(f"halo {halo} longer than a shard "
                         f"({min(s.shape[0] for s in shards)})")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of ``t`` that the process group can send."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _exchange(send: torch.Tensor | None, send_to: int | None,
              recv_like: torch.Tensor | None, recv_from: int | None, seg: int):
    """One send and/or one receive between processes; returns the
    received tensor (or None).  The send and the receive are separate
    point-to-point calls, each on the device that holds its own tensor
    (the process's last and first shard may sit on different cards, and
    NCCL takes a batch of operations on one device only).  ``seg`` is
    this process's run of shards along the line (``Line.seg``): even runs
    send first and odd runs receive first, so along the chain every send
    meets its receive without a deadlock.  Every process walks its lines
    in the same global order, so one line's chain completes before a
    later line's needs it."""
    buf = None if recv_like is None else _wire(torch.empty_like(recv_like))

    def do_send():
        if send is not None:
            dist.send(_wire(send), send_to)

    def do_recv():
        if buf is not None:
            dist.recv(buf, recv_from)

    for step in ((do_send, do_recv) if seg % 2 == 0 else (do_recv, do_send)):
        step()
    if buf is None:
        return None
    return torch.view_as_complex(buf) if recv_like.is_complex() else buf


def halo_exchange_left(shards, halo: int, mesh, axis: str = "time",
                       first=None):
    """Prepend each shard with the last ``halo`` samples of its left
    neighbour along ``axis``, within each line of the mesh along it
    (``Mesh.lines``): zeros on a line's shard 0 (a zero-history stream
    start), or ``first`` there when given (a carried stream tail)."""
    shards = list(shards)
    if halo == 0:
        return shards
    _check(shards, halo)
    out = [None] * len(shards)
    for line in mesh.lines(axis):
        js = line.local
        tails = [shards[j][shards[j].shape[0] - halo:] for j in js]
        recv = [None] + [t.to(shards[j].device, non_blocking=True)
                         for t, j in zip(tails[:-1], js[1:])]
        if line.prev is not None or line.next is not None:
            got = _exchange(None if line.next is None else tails[-1], line.next,
                            None if line.prev is None else tails[0], line.prev,
                            line.seg)
            if line.prev is not None:
                recv[0] = got.to(shards[js[0]].device)
        if recv[0] is None:
            s0 = shards[js[0]]
            recv[0] = (s0.new_zeros(halo) if first is None
                       else first.to(s0.device, s0.dtype))
        for j, r in zip(js, recv):
            out[j] = torch.cat([r, shards[j]])
    return out


def halo_exchange_right(shards, halo: int, mesh, axis: str = "time", fill=0):
    """Append each shard with the first ``halo`` samples of its right
    neighbour along ``axis``, within each line of the mesh along it
    (``fill`` on a line's last shard)."""
    shards = list(shards)
    if halo == 0:
        return shards
    _check(shards, halo)
    out = [None] * len(shards)
    for line in mesh.lines(axis):
        js = line.local
        heads = [shards[j][:halo] for j in js]
        recv = [h.to(shards[j].device, non_blocking=True)
                for h, j in zip(heads[1:], js[:-1])] + [None]
        if line.prev is not None or line.next is not None:
            got = _exchange(None if line.prev is None else heads[0], line.prev,
                            None if line.next is None else heads[-1], line.next,
                            line.seg)
            if line.next is not None:
                recv[-1] = got.to(shards[js[-1]].device)
        if recv[-1] is None:
            recv[-1] = torch.full_like(shards[js[-1]][:halo], fill)
        for j, r in zip(js, recv):
            out[j] = torch.cat([shards[j], r])
    return out
