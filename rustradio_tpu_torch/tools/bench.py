"""The port's headline benchmark (counterpart of the repository's
``bench.py``): one JSON line with ``bench.py``'s keys, the FM receive
chain's Msamples/s on the card and its companions, each row checked for
correctness before it is timed.

    python -m rustradio_tpu_torch.tools.bench [--seed 0] [--trace]
    python -m rustradio_tpu_torch.tools.bench --device cpu --small

The rows (``tools/bench_kernels.py``'s, at bench.py's sizes):

* ``value``: kernel B on packed w3 planes of 2^24 samples of wire-grid
  noise, the 49-tap channel low-pass, decimation 4 (``fm_chain/w3``);
  ``fm_chain_i8_msps`` the same on int8 planes;
* ``graph_fm_chain_msps``: the same chain built from blocks,
  ``PackedIqRingSource -> FirFilter -> QuadratureDemod -> DeviceFoldSink``
  over a ring of 4 chunks of 2^24, through ``Graph.compile_device_loop``
  (8 chunks a call, one CUDA-graph replay);
* ``channelizer_256ch_msps``: kernel H (``pfb_channelize`` with the
  channels' power), 256 channels x 2^22;
* ``decode_bank_events_msps``: ``recover_symbols_batch(method="events")``
  over 64 channels x 2^16 (kernel D).

``vs_baseline`` divides ``value`` by 85.4 Msamples/s, the reference's one
published full-chain figure (ax25-1200-rx, 79.4 Msamples in 0.929 s).
``gbps`` counts what kernel B must move, each input byte once and each
output byte once (5 B an input sample for w3 at decimation 4), over the
row's time; ``roofline_pct`` is that against the card's memory rate.
Times: the median of 5 CUDA-event timings of 10 calls, with the quartiles
(``ms_q1``, ``ms_q3``).  ``correct`` holds when every row's checks hold
(``rows``); otherwise the program exits 1.  Without a card it exits 1,
unless given ``--device cpu`` (the plain versions; ``value`` and every
other time field null).
"""

from __future__ import annotations

import sys

from . import bench_kernels, corpus, timing
from .bench_kernels import DECI, Row

BASELINE_MSPS = 85.4  # reference ax25-1200-rx: 79.4 Msamples / 0.929 s


def graph_rows(ctx):
    """The FM chain from blocks through ``Graph.compile_device_loop``
    (bench.py:253-287): ``loop_chunks`` chunks of ``loop_n`` a call over a
    packed w3 ring of 4 chunks, each call one replay of a CUDA graph."""
    from .. import blocks
    from ..graph import Graph
    from ..ops import kernels

    s = ctx.sizes
    chunk, n_chunks = s.loop_n, s.loop_chunks
    lp = corpus.fm_taps()
    ring_i, ring_q = corpus.wire_noise((2, 4 * chunk), ctx.device,
                                       ctx.gen(11)).unbind(0)

    def build(cuda_graph=True, fold=None):
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(ring_i, ring_q, lp, DECI,
                                              precision="w3",
                                              tile_rows=s.tile_rows))
        fir = g.add(blocks.FirFilter(lp, deci=DECI, precision="w3"), src)
        qd = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=fold), qd)
        loop = g.compile_device_loop(chunk, n_chunks, device=ctx.device,
                                     cuda_graph=cuda_graph)
        return lambda: next(iter(loop(0).values()))

    loop, eager = build(), build(cuda_graph=False)

    def check():
        # the timed loop's fold (the sum) against the eager loop, bit for
        # bit; a fold of sum + sum of squares (well above the sum's f32
        # rounding) against the plain versions
        def squares(c, x):
            return c + x.sum() + (x * x).sum()

        got = float(build(cuda_graph=False, fold=squares)())
        with timing.plain_versions():
            want = float(build(cuda_graph=False, fold=squares)())
        return {"CUDA-graph replay == eager loop":
                (bench_kernels.abs_err(loop(), eager()), 0.0),
                "fold of sum and squares vs the plain versions, relative":
                (abs(got - want) / abs(want), 1e-4)}

    work = kernels.fm_chain_work(chunk // DECI, len(lp), DECI, 2)
    yield Row("graph_fm_chain", n_chunks * chunk, {"": lambda k: loop()}, check,
              kernel="fm_chain", work=tuple(n_chunks * w for w in work),
              record=lambda k: eager(),
              fields={"chunk": chunk, "n_chunks": n_chunks})


def headline(ctx) -> dict:
    """bench.py's line from the rows, measured in ``ctx``."""
    rows = {}
    for group in (bench_kernels.fm_chain_rows(ctx, ("w3", "i8"), pack=False),
                  graph_rows(ctx), bench_kernels.channelizer_rows(ctx, cell=False),
                  bench_kernels.decode_bank_rows(ctx, ("events",))):
        for row in group:
            rows[row.bench] = bench_kernels.measure(row, ctx)
    w3 = rows["fm_chain/w3"]
    msps = w3["msps"]
    line = {
        "metric": "fm_demod_chain_throughput",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": None if msps is None else msps / BASELINE_MSPS,
        "gbps": w3["gbps"],
        "roofline_pct": w3["roofline_pct"],
        "platform": w3["platform"],
        "graph_fm_chain_msps": rows["graph_fm_chain"]["msps"],
        "channelizer_256ch_msps": rows[f"channelizer/{bench_kernels.PFB_CH}ch"]["msps"],
        "fm_chain_i8_msps": rows["fm_chain/i8"]["msps"],
        "decode_bank_events_msps":
            rows[f"decode_bank_events/{ctx.sizes.bank_ch}ch"]["msps"],
        **{k: w3[k] for k in ("card", "power_limit_w", "sm_clock_mhz")
           if k in w3},
        "n": w3["n"], "seed": ctx.seed,
        **{k: w3[k] for k in ("ms", "ms_q1", "ms_q3", "samples", "calls",
                              "device_ms", "host_us", "bound_ms", "bound_by")},
        "rows": {name: {k: r[k] for k in ("msps", "ms", "ms_q1", "ms_q3",
                                          "device_ms", "bound_ms", "launches",
                                          "correct")}
                 for name, r in rows.items()},
        "correct": all(r["correct"] for r in rows.values()),
    }
    return line


def main(argv=None) -> int:
    args = bench_kernels.parser("bench", __doc__).parse_args(argv)
    ctx = bench_kernels.context(args)
    if ctx is None:
        return 1
    line = headline(ctx)
    bench_kernels.emit(line)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
