"""Halo exchange between time-adjacent shards (port of
``rustradio_tpu/parallel/halo.py``).

The reference carries per-block overlap state across work() calls
(src/fft_filter.rs:336-348 tail, src/fir.rs:493-505 lookahead); with the
time axis sharded, the same samples move between neighbours.  JAX calls
these inside ``shard_map`` on one traced shard; the port has no traced
axis, so each takes the list of this process's shards and the mesh, and
returns the extended shards.  A neighbour's slice moves with
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


def _exchange(send: torch.Tensor | None, send_to: int,
              recv_like: torch.Tensor | None, recv_from: int, rank: int):
    """One send and/or one receive between processes; returns the
    received tensor (or None).  The send and the receive are separate
    point-to-point calls, each on the device that holds its own tensor
    (the process's last and first shard may sit on different cards, and
    NCCL takes a batch of operations on one device only).  Even ranks
    send first and odd ranks receive first, so along the chain every
    send meets its receive without a deadlock."""
    buf = None if recv_like is None else _wire(torch.empty_like(recv_like))

    def do_send():
        if send is not None:
            dist.send(_wire(send), send_to)

    def do_recv():
        if buf is not None:
            dist.recv(buf, recv_from)

    for step in ((do_send, do_recv) if rank % 2 == 0 else (do_recv, do_send)):
        step()
    if buf is None:
        return None
    return torch.view_as_complex(buf) if recv_like.is_complex() else buf


def halo_exchange_left(shards, halo: int, mesh, axis: str = "time",
                       first=None):
    """Prepend each shard with the last ``halo`` samples of its left
    neighbour: zeros on the global shard 0 (a zero-history stream start),
    or ``first`` there when given (a carried stream tail)."""
    shards = list(shards)
    if halo == 0:
        return shards
    _check(shards, halo)
    tails = [s[s.shape[0] - halo:] for s in shards]
    recv = [None] + [t.to(s.device, non_blocking=True)
                     for t, s in zip(tails[:-1], shards[1:])]
    if mesh.world > 1:
        last = mesh.rank == mesh.world - 1
        got = _exchange(None if last else tails[-1], mesh.rank + 1,
                        tails[0] if mesh.rank else None, mesh.rank - 1,
                        mesh.rank)
        if mesh.rank:
            recv[0] = got.to(shards[0].device)
    if recv[0] is None:
        recv[0] = (shards[0].new_zeros(halo) if first is None
                   else first.to(shards[0].device, shards[0].dtype))
    return [torch.cat([r, s]) for r, s in zip(recv, shards)]


def halo_exchange_right(shards, halo: int, mesh, axis: str = "time", fill=0):
    """Append each shard with the first ``halo`` samples of its right
    neighbour (``fill`` on the global last shard)."""
    shards = list(shards)
    if halo == 0:
        return shards
    _check(shards, halo)
    heads = [s[:halo] for s in shards]
    recv = [h.to(s.device, non_blocking=True)
            for h, s in zip(heads[1:], shards[:-1])] + [None]
    if mesh.world > 1:
        last = mesh.rank == mesh.world - 1
        got = _exchange(heads[0] if mesh.rank else None, mesh.rank - 1,
                        None if last else heads[-1], mesh.rank + 1,
                        mesh.rank)
        if not last:
            recv[-1] = got.to(shards[-1].device)
    if recv[-1] is None:
        recv[-1] = torch.full_like(shards[-1][:halo], fill)
    return [torch.cat([s, r]) for s, r in zip(shards, recv)]
