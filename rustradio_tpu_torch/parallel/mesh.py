"""Mesh construction (port of ``rustradio_tpu/parallel/mesh.py``).

A single-controller design, as JAX's ``shard_map``: one process drives
every shard of its mesh.  A :class:`Mesh` is an ordered 1-D tuple of
``torch.device``s, one per shard; a device may appear more than once (N
shards on one device), the counterpart of the JAX tests' virtual CPU
devices (``--xla_force_host_platform_device_count``).  After
:func:`init_distributed` a mesh spans the processes: each holds its own
shards, and a shard's global index is the process rank × local shards +
the local index.  ``make_mesh_2d`` is not ported (nothing uses it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist


def _world() -> tuple[int, int]:
    """(processes, this process's rank) of the ``torch.distributed`` job,
    (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A 1-D mesh: this process's shard devices (``devices``), its axis
    name, and ``shape``, the global shard count by axis name, as
    ``jax.sharding.Mesh.shape`` (``mesh.shape[axis]``)."""

    def __init__(self, devices, axis_names=("time",)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError("the port's meshes are 1-D")
        self.world, self.rank = _world()
        self.shape = {self.axis_names[0]: len(self.devices) * self.world}

    @property
    def local(self) -> int:
        """Shards held by this process."""
        return len(self.devices)

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, {self.axis_names}, "
                f"rank {self.rank} of {self.world})")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join a multi-process job (SURVEY §2.7: the reference's
    inter-process transport is TCP + the DATA_STREAM protocol; here the
    processes join one ``torch.distributed`` group and a mesh spans them).

    No-op without a coordinator (single-process runs, tests).  Otherwise
    ``coordinator`` is ``host:port`` of process 0; the backend is NCCL
    where CUDA is present and gloo where not.  Call it before building a
    mesh.
    """
    if coordinator is None:
        return  # single-process
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: int | None = None, axis: str = "time",
              device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards in all (across the processes of
    an :func:`init_distributed` job, each taking an equal part).

    By default each process takes its first CUDA devices, one shard each
    (on one host, process r its r-th group of them); ``device="cpu"`` or
    ``device="cuda:0"`` puts all of a process's shards on that one device.
    Without CUDA and without ``device=`` it raises: a mesh never lands on
    the CPU unasked.
    """
    world, rank = _world()
    if device is not None:
        n = world if n_devices is None else n_devices
        if n % world:
            raise ValueError(f"{n} shards do not divide over {world} processes")
        return Mesh([torch.device(device)] * (n // world), (axis,))
    if not torch.cuda.is_available():
        raise ValueError("make_mesh: no CUDA device; pass device= (e.g. 'cpu') "
                         "to put the shards on one device")
    have = torch.cuda.device_count()
    n = have * world if n_devices is None else n_devices
    if n % world:
        raise ValueError(f"{n} shards do not divide over {world} processes")
    k = n // world
    if k > have:
        raise ValueError(f"asked for {k} devices, have {have}")
    base = rank * k if have >= k * world else 0
    return Mesh([torch.device("cuda", base + i) for i in range(k)], (axis,))


def on_device(device):
    """The context that issues work on ``device``'s current stream: a CUDA
    device made current (a kernel wrapper launches on the current
    device's stream), nothing elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class TimeAxisSpec:
    """The port's counterpart of ``NamedSharding(mesh, P(axis))``:
    ``shard(x)`` splits the first axis of the global stream ``x`` into
    equal contiguous shards and returns this process's, each on its mesh
    device (a numpy array is taken as host data)."""

    def __init__(self, mesh: Mesh, axis: str = "time"):
        self.mesh, self.axis = mesh, axis

    def shard(self, x) -> list[torch.Tensor]:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        n_sh = self.mesh.shape[self.axis]
        if x.shape[0] % n_sh:
            raise ValueError(f"length {x.shape[0]} not divisible by {n_sh} shards")
        L = x.shape[0] // n_sh
        first = self.mesh.first
        return [x[(first + i) * L:(first + i + 1) * L].to(d)
                for i, d in enumerate(self.mesh.devices)]


def time_axis_spec(mesh: Mesh, axis: str = "time") -> TimeAxisSpec:
    return TimeAxisSpec(mesh, axis)


def global_len(x, mesh: Mesh) -> int:
    """Length of the global stream ``x``: a tensor or array, or this
    process's shards as a list: one for each of its mesh devices, all of
    one length, as :meth:`TimeAxisSpec.shard` makes them (a shard's
    global offset is its index × that length; every process of a mesh
    across processes is taken to hold as much)."""
    if isinstance(x, (list, tuple)):
        lens = {int(s.shape[0]) for s in x}
        if len(x) != mesh.local or len(lens) != 1:
            raise ValueError(
                f"expected {mesh.local} shards of one length, got lengths "
                f"{[int(s.shape[0]) for s in x]}")
        return lens.pop() * mesh.shape[mesh.axis_names[0]]
    return int(x.shape[0])
