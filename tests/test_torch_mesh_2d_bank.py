"""The channel-sharded clock recovery on a 2-D mesh against the JAX
package's sharded bank on the same mesh shape (``jpar.make_mesh_2d(4, 2)``
and ``(2, 4)`` on the 8 virtual CPU devices of ``tests/conftest.py``),
both methods, at the tolerances of ``tests/test_parallel.py::
test_sharded_symbol_sync_bank`` that ``tests/test_torch_parallel.py``
keeps for the 1-D mesh: masks equal, values within 1e-6, clocks within
1e-5.  The JAX banks compile for ~20 s on the CPU, so the test is
``slow``; ``tests/test_torch_mesh_2d.py`` holds the port's 2-D bank to
its 1-D and unsharded banks bit for bit in the quick tier."""

import numpy as np
import pytest
import torch

import rustradio_tpu.parallel as jpar
from rustradio_tpu_torch import parallel
from rustradio_tpu_torch.parallel import make_mesh_2d
from test_torch_mesh_2d import _nrz_bank


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_torch_mesh_2d_symbol_sync_bank_matches_jax_sharded(shape):
    xs, sps = _nrz_bank(3), 10.0
    jmesh = jpar.make_mesh_2d(*shape)
    mesh = make_mesh_2d(*shape, device="cpu")
    for method in ("scan", "events"):
        vj, mj, cj = jpar.sharded_symbol_sync_bank(xs, sps, jmesh, method=method)
        vals, mask, clk = parallel.sharded_symbol_sync_bank(
            torch.from_numpy(xs), sps, mesh, method=method)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(mj))
        np.testing.assert_allclose(vals.numpy(), np.asarray(vj), atol=1e-6)
        np.testing.assert_allclose(clk.numpy(), np.asarray(cj), atol=1e-5)
