"""Mesh construction (port of ``rustradio_tpu/parallel/mesh.py``).

A single-controller design, as JAX's ``shard_map``: one process drives
every shard of its mesh.  A :class:`Mesh` is a grid of ``torch.device``s
with named axes, one device per shard; a device may appear more than once
(N shards on one device), the counterpart of the JAX tests' virtual CPU
devices (``--xla_force_host_platform_device_count``).  After
:func:`init_distributed` a mesh spans the processes: the grid's shards, in
row-major order, are dealt out to the processes in equal runs (process r
holds the global flat indices ``r * local .. (r + 1) * local - 1``).

An operation sharded over axis ``a`` splits its stream over
``mesh.shape[a]`` shards and is replicated along the other axes, as
``shard_map(.., in_specs=P(a))`` is: each *line* of the grid along ``a``
(:meth:`Mesh.lines`) runs the operation, and every line holds the same
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist


def _world() -> tuple[int, int]:
    """(processes, this process's rank) of the ``torch.distributed`` job,
    (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class _Shape(dict):
    """``Mesh.shape``: the global shard count by axis name; an axis the mesh
    lacks raises ValueError naming the mesh's axes."""

    def __missing__(self, axis):
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                         f"{tuple(self)}")


@dataclasses.dataclass(frozen=True)
class Line:
    """This process's part of one line of the grid along an axis: the
    shards that share their coordinates on the other axes.

    ``index`` — the line's global index (row-major over the other axes);
    ``local`` — this process's shards on it, as indices into
    ``Mesh.devices``, in axis order; ``ks`` — their coordinates along the
    axis (contiguous); ``prev`` / ``next`` — the rank holding the shard
    before ``ks[0]`` / after ``ks[-1]`` on the line, None where the line
    ends there; ``seg`` — the index of this process's run of shards among
    the line's runs by process (its parity orders a cross-process
    exchange)."""

    index: int
    local: tuple
    ks: tuple
    prev: int | None
    next: int | None
    seg: int


class Mesh:
    """A mesh: this process's shard devices (``devices``, in the grid's
    row-major order), the axis names, the global grid (``grid``, one size
    per axis; by default one axis of every process's shards) and
    ``shape``, the global shard count by axis name, as
    ``jax.sharding.Mesh.shape`` (``mesh.shape[axis]``)."""

    def __init__(self, devices, axis_names=("time",), grid=None):
        self.axis_names = tuple(axis_names)
        self.world, self.rank = _world()
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if grid is None:
            grid = (len(self.devices) * self.world,)
        self.grid = tuple(int(g) for g in grid)
        if len(self.grid) != len(self.axis_names) or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"axes {self.axis_names} do not name the grid "
                             f"{self.grid} one each")
        if math.prod(self.grid) != len(self.devices) * self.world:
            raise ValueError(f"a grid of {self.grid} is not {self.world} "
                             f"process(es) x {len(self.devices)} shards")
        self.shape = _Shape(zip(self.axis_names, self.grid))
        self._lines: dict[str, list[Line]] = {}
        self._seen: list | None = None

    @property
    def local(self) -> int:
        """Shards held by this process."""
        return len(self.devices)

    @property
    def first(self) -> int:
        """Global flat index of this process's first shard."""
        return self.rank * self.local

    def axis_index(self, axis: str) -> int:
        """The position of ``axis`` in ``axis_names``; ValueError naming
        the mesh's axes when it has none of that name."""
        self.shape[axis]  # raises for an unknown axis
        return self.axis_names.index(axis)

    def coords(self, j: int) -> tuple:
        """Global grid coordinates of this process's shard ``j``."""
        return tuple(int(c) for c in np.unravel_index(self.first + j, self.grid))

    def _line_owners(self, a: int, key: tuple) -> list[int]:
        """The rank holding each shard of the line along axis ``a`` whose
        coordinates on the other axes are ``key``."""
        return [int(np.ravel_multi_index(key[:a] + (k,) + key[a:], self.grid))
                // self.local for k in range(self.grid[a])]

    def lines(self, axis: str) -> list[Line]:
        """The lines of the grid along ``axis`` that hold a shard of this
        process, in global order: for each index of the other axes, the
        devices along ``axis`` with each shard's coordinate on it.  A
        process's shards on a line are contiguous along it: the line's
        flat indices rise with the coordinate, and a process holds one run
        of flat indices."""
        if axis in self._lines:
            return self._lines[axis]
        a = self.axis_index(axis)
        groups: dict[tuple, list[tuple[int, int]]] = {}
        for j in range(self.local):
            c = self.coords(j)
            groups.setdefault(c[:a] + c[a + 1:], []).append((c[a], j))
        others = self.grid[:a] + self.grid[a + 1:]
        out = []
        for key in sorted(groups, key=lambda k: np.ravel_multi_index(k, others)
                          if others else 0):
            ks, js = zip(*sorted(groups[key]))
            owners = self._line_owners(a, key)
            runs = [i for i in range(len(owners)) if i == 0 or owners[i] != owners[i - 1]]
            out.append(Line(
                index=int(np.ravel_multi_index(key, others)) if others else 0,
                local=js, ks=ks,
                prev=owners[ks[0] - 1] if ks[0] > 0 else None,
                next=owners[ks[-1] + 1] if ks[-1] < self.grid[a] - 1 else None,
                seg=runs.index(ks[0])))
        self._lines[axis] = out
        return out

    def home(self, axis: str) -> Line:
        """The line along ``axis`` through this process's first shard: the
        one whose result a sharded call returns."""
        return next(ln for ln in self.lines(axis) if 0 in ln.local)

    def crosses(self, axis: str) -> bool:
        """Whether a line along ``axis`` spans more than one process."""
        a = self.axis_index(axis)
        others = self.grid[:a] + self.grid[a + 1:]
        return any(len(set(self._line_owners(a, tuple(int(c) for c in key)))) > 1
                   for key in np.ndindex(*others))

    def end_owner(self, axis: str) -> int:
        """The rank holding the last shard of line 0 along ``axis``: the
        process whose result every other one takes where the axis crosses
        processes."""
        a = self.axis_index(axis)
        return self._line_owners(a, (0,) * (len(self.grid) - 1))[-1]

    @contextlib.contextmanager
    def replicas(self):
        """Record what every replica line of this mesh holds.  Inside, each
        call sharded on it appends to the yielded list, for each of its
        outputs (and, for a mesh segment, each carried tail), one list
        with a tensor per line along the call's axis that this process
        holds: that line's part, on the mesh's first device.  Every
        entry's tensors are equal when the lines agree; a call returns
        its home line's."""
        prev, self._seen = self._seen, []
        try:
            yield self._seen
        finally:
            self._seen = prev

    def record(self, per_line) -> None:
        """Append one entry (a tensor per line) to :meth:`replicas`' list,
        when one records (``per_line`` is not consumed otherwise)."""
        if self._seen is not None:
            self._seen.append(list(per_line))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, {self.axis_names}, "
                f"grid {self.grid}, rank {self.rank} of {self.world})")


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


def _local_devices(n: int | None, device, what: str) -> list[torch.device]:
    """This process's share of ``n`` shards, by :func:`make_mesh`'s rules
    (``n`` None: one a process on ``device``, else every card)."""
    world, rank = _world()
    if device is not None:
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise ValueError(f"{what}(device={device!r}): no CUDA device here")
    elif not torch.cuda.is_available():
        raise ValueError(f"{what}: no CUDA device; pass device= (e.g. 'cpu') "
                         "to put the shards on one device")
    if n is None:
        n = world if device is not None else torch.cuda.device_count() * world
    if n % world:
        raise ValueError(f"{n} shards do not divide over {world} processes")
    k = n // world
    if device is not None:
        return [torch.device(device)] * k
    have = torch.cuda.device_count()
    if k > have:
        raise ValueError(f"asked for {k} devices, have {have}")
    base = rank * k if have >= k * world else 0
    return [torch.device("cuda", base + i) for i in range(k)]


def make_mesh(n_devices: int | None = None, axis: str = "time",
              device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards in all (across the processes of
    an :func:`init_distributed` job, each taking an equal part).

    By default each process takes its first CUDA devices, one shard each
    (on one host, process r its r-th group of them); ``device="cpu"`` or
    ``device="cuda:0"`` puts all of a process's shards on that one device.
    Without CUDA, without ``device=`` or with a CUDA ``device=``, it
    raises: a mesh never lands on the CPU unasked.
    """
    return Mesh(_local_devices(n_devices, device, "make_mesh"), (axis,))


def make_mesh_2d(n_time: int, n_chan: int, device=None) -> Mesh:
    """A 2-D mesh: channel-parallel x time-parallel (for the channelizer),
    axes ``("chan", "time")`` of sizes ``(n_chan, n_time)``.

    As JAX lays it out: the first ``n_time * n_chan`` devices in
    process-major order (each process an equal run of them, as
    :func:`make_mesh` takes them), reshaped row-major to
    ``(n_chan, n_time)``, so the time axis runs within a process first.
    ``device=`` puts every shard on that one device; without it the
    shards take the CUDA devices, and too few of them, or none, raises.
    """
    devs = _local_devices(n_time * n_chan, device, "make_mesh_2d")
    return Mesh(devs, ("chan", "time"), grid=(n_chan, n_time))


def on_device(device):
    """The context that issues work on ``device``'s current stream: a CUDA
    device made current (a kernel wrapper launches on the current
    device's stream), nothing elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def gather_lines(parts, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The output of a call sharded over ``axis``: the home line's parts
    (``parts`` has one per shard of this process) concatenated along
    ``dim`` on the mesh's first device; under :meth:`Mesh.replicas` every
    line's is recorded."""
    dev = mesh.devices[0]

    def cat(line):
        return torch.cat([parts[j].to(dev) for j in line.local], dim)

    mesh.record(cat(ln) for ln in mesh.lines(axis))
    return cat(mesh.home(axis))


class TimeAxisSpec:
    """The port's counterpart of ``NamedSharding(mesh, P(axis))``:
    ``shard(x)`` splits the first axis of the global stream ``x`` into
    ``mesh.shape[axis]`` equal contiguous shards and returns this
    process's, one for each of its mesh devices, each on its device: the
    shard at that device's coordinate along ``axis`` (a replica on
    another line holds the same shard).  A numpy array is taken as host
    data."""

    def __init__(self, mesh: Mesh, axis: str = "time"):
        self.mesh, self.axis = mesh, axis

    def shard(self, x) -> list[torch.Tensor]:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        n_sh = self.mesh.shape[self.axis]
        if x.shape[0] % n_sh:
            raise ValueError(f"length {x.shape[0]} not divisible by {n_sh} shards")
        L = x.shape[0] // n_sh
        a = self.mesh.axis_index(self.axis)
        out = []
        for j, d in enumerate(self.mesh.devices):
            k = self.mesh.coords(j)[a]
            out.append(x[k * L:(k + 1) * L].to(d))
        return out


def time_axis_spec(mesh: Mesh, axis: str = "time") -> TimeAxisSpec:
    return TimeAxisSpec(mesh, axis)


def global_len(x, mesh: Mesh, axis: str) -> int:
    """Length of the global stream ``x``: a tensor or array, or this
    process's shards as a list: one for each of its mesh devices, all of
    one length, as :meth:`TimeAxisSpec.shard` makes them (a shard's
    global offset is its coordinate along ``axis`` × that length)."""
    if isinstance(x, (list, tuple)):
        lens = {int(s.shape[0]) for s in x}
        if len(x) != mesh.local or len(lens) != 1:
            raise ValueError(
                f"expected {mesh.local} shards of one length, got lengths "
                f"{[int(s.shape[0]) for s in x]}")
        return lens.pop() * mesh.shape[axis]
    return int(x.shape[0])
