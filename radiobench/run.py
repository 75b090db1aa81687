"""Run one cell of ``BENCHMARK.json`` once, on one NVIDIA card:

    python -m radiobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from ``--seed``, builds what
its driver needs and warms every shape up; the window then runs the
driver for ``--seconds`` seconds (closed loop); the check compares what
the window's passes produced with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted`` (the
window's passes or chunks), ``failed`` (all of them when the check fails,
else 0), ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones, read in a ``torch.profiler`` trace of the
window), ``device`` and, traced, ``breakdown``; last in it, ``checks``:
each compared number with its limit, which the last lines of standard
error repeat.

Without a card, or with fewer than the cell asks for, the run exits 1
and prints no result; so it does where the program is missing.  If a
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``rustradio_tpu`` is loaded once the window has closed, it names them on
standard error and exits 3 without a result.  Every cache of the run
lies in ``.radiobench_cache/`` inside the checkout; the program builds
its kernels into its own ``_build/`` there.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv",
              "TORCHINDUCTOR_CACHE_DIR": "torchinductor"}


def set_cache_dirs() -> None:
    from .harness import CACHE_DIR

    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE_DIR / sub)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             clock=None) -> dict:
    """One run of ``cell`` on ``device``: the result's fields, with the
    compared numbers under ``compared``."""
    import torch

    from .generators import make_inputs
    from .harness import Clock, Run, module

    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=torch.device(device), clock=clock or Clock())
    cuda = run.device.type == "cuda"
    try:
        run.inputs = make_inputs(cell.traffic, cell.config, seed, run.device)
        driver = module("drivers", cell.driver)
        driver.prepare(run)
        gc.collect()
        if cuda:
            torch.cuda.synchronize(run.device)
            torch.cuda.reset_peak_memory_stats(run.device)
        run.setup_s = run.clock.now() - run.clock.t0
        tr = None
        if trace:
            from .trace import Tracer

            with Tracer(cuda) as tracer:
                run.tracer = tracer
                window = driver.window(run)
            run.tracer = None
            tr = tracer.read()
        else:
            window = driver.window(run)
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = module("metrics", m["name"]).read(run, window, tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        breakdown = None
        if tr is not None:
            dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        cleanup = run.state.pop("cleanup", None)
        run.state.clear()
        if cleanup:
            cleanup()
        gc.collect()
        compared = module("reference", cell.check).judge(run, window)
        correct = all(c.ok for c in compared)
        return {"correct": correct, "attempted": window.units,
                "failed": 0 if correct else window.units, "metrics": metrics,
                "device": dev, "breakdown": breakdown, "compared": compared,
                "run": run, "window": window}
    finally:
        cleanup = run.state.pop("cleanup", None)
        if cleanup:
            cleanup()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opt = p.parse_args(argv)
    set_cache_dirs()

    from .harness import forbidden_modules, load_cell, result_line

    try:
        cell = load_cell(opt.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"radiobench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"radiobench: {opt.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    from .harness import Clock

    res = run_cell(cell, opt.seed, opt.seconds, bool(opt.trace), "cuda:0",
                   Clock(T_START))
    found = forbidden_modules()
    if found:
        print(f"radiobench: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 3
    for c in res["compared"]:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(res["correct"], res["attempted"], res["failed"],
                      res["metrics"], res["device"], res["compared"],
                      res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
