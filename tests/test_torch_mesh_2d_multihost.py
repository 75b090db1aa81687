"""A 2-D mesh across two gloo processes, as
``tests/test_torch_dryrun_multihost.py`` runs its processes: each process
holds 2 CPU shards of ``make_mesh_2d(2, 2, device="cpu")``, process r the
chan row r (JAX's process-major layout), so the ``time`` axis lies within
each process and ``chan`` crosses the process boundary.

* the clock-recovery bank sharded over ``chan``: each process's channels,
  gathered, bit-equal to the unsharded bank;
* the FIR sharded over ``time``: replicated across the processes, each
  process's output bit-equal to the offline full convolution;
* the FIR and the discriminator sharded over ``chan``: left and right
  halos cross the processes on both lines; every line of a process holds
  the same output (``Mesh.replicas``);
* the FM chain as a mesh segment over ``chan`` in two chunks
  (``MeshSegment.run_chunk``): the carries that the process holding the
  lines' last shard sends, the streamed output the one shot's;
* a two-stage pipeline along ``chan``: one stage a process on each line,
  every process holding the composition.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from rustradio_tpu_torch import blocks, ops, parallel, taps
from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
from rustradio_tpu_torch.parallel import init_distributed, make_mesh_2d
from rustradio_tpu_torch.parallel.graph_mesh import chain_segment

coord, pid = sys.argv[1], int(sys.argv[2])
init_distributed(coordinator=coord, num_processes=2, process_id=pid)
mesh = make_mesh_2d(2, 2, device="cpu")
assert [mesh.coords(j) for j in range(2)] == [(pid, 0), (pid, 1)]
assert mesh.crosses("chan") and not mesh.crosses("time")
assert [(ln.prev, ln.next, ln.seg) for ln in mesh.lines("chan")] == (
    [(None, 1, 0)] * 2 if pid == 0 else [(0, None, 1)] * 2)


def gathered(part):
    # both processes' parts, tiled; they may differ in length (the
    # stream-start drop is on process 0's)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
    dist.all_gather(lens, torch.tensor([part.shape[0]]))
    size = max(int(v) for v in lens)
    pad = part.new_zeros((size - part.shape[0],) + tuple(part.shape[1:]))
    parts = [part.new_zeros((size,) + tuple(part.shape[1:])) for _ in range(2)]
    dist.all_gather(parts, torch.cat([part, pad]).contiguous())
    return torch.cat([q[: int(v)] for q, v in zip(parts, lens)])


def lines_agree(seen):
    return all(torch.equal(t, e[0]) for e in seen for t in e)


rng = np.random.RandomState(0)
# the bank over chan: channels split across the processes
bits = rng.randint(0, 2, (4, 60)) * 2.0 - 1.0
xs = torch.from_numpy((np.repeat(bits, 10, axis=1)
                       + 0.05 * rng.randn(4, 600)).astype(np.float32))
for method in ("scan", "events"):
    with mesh.replicas() as seen:
        got = parallel.sharded_symbol_sync_bank(xs, 10.0, mesh, method=method)
    assert lines_agree(seen) and got[0].shape == (2, 600)
    one = recover_symbols_batch(xs, 10.0, method=method)
    assert all(torch.equal(gathered(a), b) for a, b in zip(got, one)), method

x = torch.from_numpy((rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64))
t = rng.randn(33).astype(np.float32).astype(np.complex64)
full = ops.fir_filter_full(x, t)
# the FIR over time: within each process, replicated across them
y = parallel.sharded_fir_filter(x, t, mesh, axis="time")
assert torch.equal(y, full) and torch.equal(gathered(y), torch.cat([full, full]))
# the FIR and the discriminator over chan: the halos cross the processes
with mesh.replicas() as seen:
    y = parallel.sharded_fir_filter(x, t, mesh, axis="chan")
    q = parallel.sharded_quadrature_demod(x, 0.7, mesh, axis="chan")
assert lines_agree(seen) and len(seen) == 2 and all(len(e) == 2 for e in seen)
assert torch.equal(gathered(y), full)
q = gathered(q)
assert float(q[-1]) == 0.0
assert float((q[:-1] - ops.quadrature_demod(x, 0.7)).abs().max()) <= 1e-6
# the FM chain over chan in two chunks: the carries cross the processes
lp = taps.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0)
ms = chain_segment([blocks.FirFilter(lp, 4), blocks.QuadratureDemod(1.0)], mesh, "chan")
_, (whole,) = ms.run({}, {}, x)
carries, streamed = ms.init_carries(x), []
with mesh.replicas() as seen:
    for c in (0, 2048):
        carries, (o,), _ = ms.run_chunk(carries, x[c:c + 2048], c)
        streamed.append(gathered(o))
assert lines_agree(seen)
streamed = torch.cat(streamed)
assert torch.equal(streamed, gathered(whole)[: streamed.shape[0]])
# a two-stage pipeline along chan: stage r on process r, on both lines
chunks = torch.from_numpy(rng.randn(5, 64).astype(np.float32))
with mesh.replicas() as seen:
    p = parallel.pipeline_run([lambda v: v * 2.0, lambda v: v + 1.0], chunks, mesh,
                              axis="chan")
assert lines_agree(seen) and torch.equal(p, chunks * 2.0 + 1.0)
print("MESH2D_OK", pid)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow  # two fresh interpreters join a process group: ~4-5 s
def test_torch_mesh_2d_across_two_gloo_processes():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(ROOT))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"MESH2D_OK {i}" in out, (out + err)[-2000:]
