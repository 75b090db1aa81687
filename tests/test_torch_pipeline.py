"""The stage pipeline (``parallel.pipeline_run``, ``pipeline_run_rates``,
``pipeline_chain``) of the port against the JAX package's
(``tests/test_parallel.py:94-155``): the same numpy chunks from one seed,
the JAX pipeline on the virtual CPU devices ``tests/conftest.py`` forces,
the port's on ``make_mesh(n, axis="stage", device="cpu")`` (stage d on
shard d), each against the composition of its stages at the JAX test's
tolerance and against the JAX package's output.  The pipeline across
processes runs in ``tests/test_torch_dryrun_multihost.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustradio_tpu.ops as jops
import rustradio_tpu.parallel as jpar
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.parallel import (
    make_mesh,
    pipeline_chain,
    pipeline_run,
    pipeline_run_rates,
)

JAX_STAGES = [lambda v: v * jnp.float32(2.0), lambda v: v + jnp.float32(1.0),
              jnp.tanh, lambda v: v - jnp.float32(0.25)]
STAGES = [lambda v: v * 2.0, lambda v: v + 1.0, torch.tanh, lambda v: v - 0.25]


def test_torch_pipeline_stages_match_composition():
    mesh = make_mesh(4, axis="stage", device="cpu")
    rng = np.random.RandomState(0)
    chunks = rng.randn(7, 256).astype(np.float32)
    want = np.tanh(chunks * 2.0 + 1.0) - 0.25
    got = pipeline_run(STAGES, chunks, mesh)
    assert got.shape == (7, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    jmesh = jpar.make_mesh(4, axis="stage")
    theirs = np.asarray(jpar.pipeline_run(JAX_STAGES, chunks, jmesh))
    np.testing.assert_allclose(got.numpy(), theirs, atol=1e-6)

    x = rng.randn(1024).astype(np.float32)
    got2 = pipeline_chain(STAGES, x, mesh, chunk_len=256)
    np.testing.assert_allclose(got2.numpy(), np.tanh(x * 2.0 + 1.0) - 0.25,
                               atol=1e-6)
    np.testing.assert_allclose(
        got2.numpy(), np.asarray(jpar.pipeline_chain(JAX_STAGES, x, jmesh, 256)),
        atol=1e-6)
    with pytest.raises(ValueError, match="multiple of chunk_len"):
        pipeline_chain(STAGES, x[:1000], mesh, chunk_len=256)
    with pytest.raises(ValueError, match="must have 3 devices"):
        pipeline_run(STAGES[:3], chunks, mesh)


def test_torch_pipeline_run_rates_decimating():
    # a decimating filter stage, then a demod stage, stage per device
    # (reference src/mtgraph.rs:73-149 with rate-changing blocks)
    mesh = make_mesh(2, axis="stage", device="cpu")
    rng = np.random.RandomState(7)

    def filt_deci(x):  # (1024,) c64 -> (256,) c64: boxcar decimate by 4
        return x.reshape(-1, 4).mean(1)

    def demod(x):  # (256,) c64 -> (255,) stored complex
        return ops.quadrature_demod(x, 1.0).to(torch.complex64)

    def jdemod(x):
        return jops.quadrature_demod(x, 1.0).astype(jnp.complex64)

    chunks = (rng.randn(6, 1024) + 1j * rng.randn(6, 1024)).astype(np.complex64)
    got = pipeline_run_rates([(filt_deci, 1024, 256), (demod, 256, 255)],
                             chunks, mesh)
    assert got.shape == (6, 255) and got.dtype == torch.complex64
    for i in range(6):
        want = demod(filt_deci(torch.from_numpy(chunks[i])))
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-5)
    theirs = np.asarray(jpar.pipeline_run_rates(
        [(lambda v: v.reshape(-1, 4).mean(axis=1), 1024, 256), (jdemod, 256, 255)],
        chunks, jpar.make_mesh(2, axis="stage")))
    np.testing.assert_allclose(got.numpy(), theirs, atol=1e-5)


def test_torch_pipeline_run_rates_rejects_mismatch():
    mesh = make_mesh(2, axis="stage", device="cpu")
    with pytest.raises(ValueError, match="stage 0 emits 8 but stage 1 takes 9"):
        pipeline_run_rates([(lambda x: x, 8, 8), (lambda x: x, 9, 9)],
                           np.zeros((2, 8), np.complex64), mesh)
    with pytest.raises(ValueError, match="in_len of stage 0"):
        pipeline_run_rates([(lambda x: x, 8, 8), (lambda x: x, 8, 8)],
                           np.zeros((2, 9), np.complex64), mesh)
    with pytest.raises(ValueError, match="emitted"):
        pipeline_run_rates([(lambda x: x[:4], 8, 8), (lambda x: x, 8, 8)],
                           np.zeros((2, 8), np.complex64), mesh)
