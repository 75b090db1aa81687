"""The AX.25 1200 bd receiver built from blocks on a mesh
(``ax25_1200_rx_graph(mesh=)``, the reference's one-flag MTGraph swap,
examples/ax25-1200-rx.rs:209-213) and the batched runner over a mesh
segment (``run_stream(mesh=, scan_chunks=)``), in the port against the
JAX package's ``tests/test_graph_mesh.py`` on the 8 virtual CPU devices
and against the port's own unsharded runs.  The JAX outputs are computed
once per module (``jax_run``); see ``tests/test_torch_graph_mesh.py``
for the conventions.
"""

import numpy as np
import pytest
import torch

# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process (~2 s); import it with the module instead, so
# that no test's time holds it
import torch._dynamo  # noqa: F401

from rustradio_tpu.models.ax25 import ax25_1200_rx_graph as jax_rx_graph
from rustradio_tpu_torch.models import ax25
from test_models import make_afsk
from test_torch_graph_mesh import (  # noqa: F401
    bell, hold_demod, jax_run, meshes, run_graph)

FS = 24000.0
PAYLOADS = [b"MESH GRAPH FRAME ONE", b"MESH GRAPH FRAME TWO!"]


@pytest.fixture(scope="module")
def audio():
    return np.concatenate([make_afsk(p, fs=FS, lead_zeros=500) for p in PAYLOADS])


@pytest.fixture(scope="module")
def jax_lists(meshes, audio):
    """The JAX receiver on its mesh, offline and streamed in 16000s."""
    return [jax_rx_graph(audio, FS, mesh=meshes[0]),
            jax_rx_graph(audio, FS, mesh=meshes[0], chunk_size=16000)]


def test_torch_ax25_receiver_from_blocks_on_mesh(meshes, jax_lists, audio):
    assert jax_lists == [PAYLOADS, PAYLOADS]
    mesh = meshes[1]
    x = torch.from_numpy(audio)  # a tensor runs on its own device, the mesh's
    assert ax25.ax25_1200_rx_graph(x, FS) == PAYLOADS
    assert ax25.ax25_1200_rx_graph(x, FS, mesh) == PAYLOADS
    assert ax25.ax25_1200_rx_graph(x, FS, mesh=mesh, chunk_size=16000) == PAYLOADS
    assert [bytes(p) for p in ax25.ax25_1200_rx(audio, FS, device="cpu")] == PAYLOADS


@pytest.mark.parametrize("sync", ["native", "events"])
def test_torch_ax25_receiver_on_mesh_batched_and_both_syncs(meshes, audio, sync):
    """Both clock recoveries behind the mesh front-end, per chunk and with
    ``scan_chunks`` (chunks of 4096 = 8 shards x 512: the ragged last one
    demotes the front-end)."""
    x = torch.from_numpy(audio)
    for scan in (None, 3):
        assert ax25.ax25_1200_rx_graph(x, FS, meshes[1], chunk_size=4096,
                                       sync=sync, scan_chunks=scan) == PAYLOADS


def test_torch_mesh_with_scan_chunks(meshes, jax_run):
    """The bell chain batched on the mesh: each batch of 4 chunks through
    ``MeshSegment.run_batch``, bit-equal to the per-chunk mesh run; against
    the JAX package's per-chunk run unsharded (the JAX test's reference) at
    1e-5 (its tolerance)."""
    data = np.random.RandomState(8).randn(48000).astype(np.float32)
    want = jax_run("bell_scan", lambda m: run_graph("jax", bell, data, None, 4800)[0][0])
    got, g = run_graph("port", bell, data, meshes[1], 4800, scan_chunks=4)
    per_chunk, _ = run_graph("port", bell, data, meshes[1], 4800)
    plain, _ = run_graph("port", bell, data, None, 4800, scan_chunks=4)
    np.testing.assert_array_equal(got[0], per_chunk[0])
    hold_demod(got[0], want, 1e-5)
    np.testing.assert_allclose(got[0], plain[0], atol=1e-5, rtol=0)
    assert g.demotions == []
