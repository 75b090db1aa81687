"""The decode-bank rows of the port's micro-benchmarks
(``rustradio_tpu_torch/tools/bench_kernels.py``) against the JAX package's
``recover_symbols_batch`` on the same bank: the JAX scans compile for
4-8 s on the CPU, so these sit apart from tests/test_torch_bench.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustradio_tpu.models import multichannel as jmc
from rustradio_tpu_torch.models import multichannel
from rustradio_tpu_torch.tools import corpus


@pytest.mark.slow
@pytest.mark.parametrize("method", ["scan", "events"])
def test_torch_bench_decode_bank_row_matches_jax(method):
    gen = torch.Generator().manual_seed(7)
    bank = corpus.decode_bank("cpu", gen, 2, 1 << 11)
    kw = {"max_events": 1024} if method == "events" else {}
    got = multichannel.recover_symbols_batch(bank, corpus.BANK_SPS, 0.5, (0.5, 0.5),
                                             method=method, **kw)
    want = jmc.recover_symbols_batch(jnp.asarray(bank.numpy()), corpus.BANK_SPS, 0.5,
                                     (0.5, 0.5), method=method, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
