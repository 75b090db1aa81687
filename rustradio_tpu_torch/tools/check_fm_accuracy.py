"""Kernel B's accuracy in each precision mode (counterpart of
``benches/check_fm_accuracy.py``): one JSON line a mode with its max
|error| in radians against the float64 model.

    python -m rustradio_tpu_torch.tools.check_fm_accuracy [--seed 7]
    python -m rustradio_tpu_torch.tools.check_fm_accuracy --device cpu --small

The input is the JAX script's: 2^18 samples of I and Q on the 8-bit wire
grid, (u8 - 127)/128 with u8 uniform from numpy's RandomState (seed 7 by
default, the script's), through the 49-tap channel low-pass at
decimation 4 on flat f32 planes (``kernels.fm_chain``, cast to each mode's
plane once a call); the model is ``tools.corpus.fm_chain_f64``, the
script's float64 model.  ``within_1e3_budget`` is the JAX script's
1e-3 rad bar; ``correct`` holds each mode to its own budget (2e-4 rad
highest, 3e-4 w3 and i8, 8e-3 w2, 3e-3 split3).  A line also carries the
call's time (the median of 5 CUDA-event timings of 10 calls, with the
quartiles; the planes fit in L2) and, since kernel B carries it, its
device time, bound and rate.  Exits 1 if a mode misses its budget, or
without a card unless given ``--device cpu`` (the plain versions, every
time field null).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import bench_kernels, corpus
from .bench_kernels import BUDGET, DECI, Row

PRECISIONS = ("highest", "w3", "i8", "w2", "split3")  # the script's order
N = 1 << 18


def accuracy_rows(ctx):
    from ..ops import kernels

    n = min(N, ctx.sizes.fm_n)
    rng = np.random.RandomState(ctx.seed)
    a = (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0
    b = (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0
    lp = kernels.tapset(corpus.fm_taps())
    want = corpus.fm_chain_f64(a, b, lp, 1.0, DECI)
    da, db = (torch.from_numpy(v).to(ctx.device) for v in (a, b))
    for prec in PRECISIONS:
        def run(k, prec=prec):
            return kernels.fm_chain(da, db, lp, DECI, 1.0, precision=prec)

        fields = {"precision": prec}

        def check(run=run, prec=prec, fields=fields):
            err = bench_kernels.abs_err(run(0), want)
            fields.update(max_err_rad=err, within_1e3_budget=err <= 1e-3,
                          budget_rad=BUDGET[prec])
            return {"float64 model": (err, BUDGET[prec])}

        yield Row(f"check_fm_accuracy/{prec}", n, {"": run}, check,
                  kernel="fm_chain",
                  work=kernels.fm_chain_work(-(-n // DECI), len(lp), DECI,
                                             bench_kernels.PLANE_BYTES[prec]),
                  fields=fields)


def lines(ctx) -> list[dict]:
    """One line a mode, measured in ``ctx``."""
    out = []
    for row in accuracy_rows(ctx):
        line = bench_kernels.measure(row, ctx)
        del line["bench"]
        out.append(line)
    return out


def main(argv=None) -> int:
    p = bench_kernels.parser("check_fm_accuracy", __doc__)
    p.set_defaults(seed=7)
    ctx = bench_kernels.context(p.parse_args(argv))
    if ctx is None:
        return 1
    ok = True
    for line in lines(ctx):
        bench_kernels.emit(line)
        ok &= line["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
