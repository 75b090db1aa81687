"""What every cell shares: finding a cell's files by name, the run's
context, the window's record, the compared numbers and the result line.

A cell is the entry of ``BENCHMARK.json``'s ``workloads`` with its name;
``workloads/<cell>.json`` names its ``driver`` (``drivers/<driver>.py``:
the port's entry that the window drives, with its ``driver_args``), its
``check`` (``reference/<check>.py``: the comparison that decides
``correct``) and the ``limits`` of the numbers that check compares.  Its
configuration is ``configs/<config>.json`` and its traffic
``traffic/<traffic>.json``, whose signal ``generators/<generator>.py``
makes.  A metric named in ``BENCHMARK.json`` is read by
``metrics/<name>.py``.  So a new cell, traffic mix, configuration or
metric is a new file, found by its name, and no file here changes.

Nothing here imports the program (the ``rustradio_tpu_torch`` package):
the drivers do, when a run calls them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Any

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
CACHE_DIR = ROOT / ".radiobench_cache"  # every cache and scratch file of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "rustradio_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {MANIFEST.name}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """A cell with everything its files say."""

    name: str
    entry: dict      # BENCHMARK.json's workloads entry
    workload: dict   # workloads/<name>.json
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json's metrics that this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def check(self) -> str:
        return self.workload["check"]


def load_cell(name: str, man: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest ``man`` (``BENCHMARK.json``),
    its files read under the checkout ``root``."""
    man = manifest(root / MANIFEST.name) if man is None else man
    entry = _named(man["workloads"], name, "workload")
    conf = _named(man["configs"], entry["config"], "config")
    bench = root / BENCH_DIR.name
    return Cell(
        name=name,
        entry=entry,
        workload=load_json(bench / "workloads" / f"{name}.json"),
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def module(kind: str, name: str):
    """``radiobench.<kind>.<name>``: a driver, a check, a metric or a
    generator."""
    return importlib.import_module(f"radiobench.{kind}.{name}")


@dataclasses.dataclass
class Compared:
    """One number the check compares, beside its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a driver's measured window did.

    ``seconds`` is the window's length by the host's clock; ``samples``
    the input samples of the work it completed; ``units`` the passes or
    chunks it completed (``unit`` says which).  ``outputs`` is what the
    check judges."""

    seconds: float
    samples: int
    units: int
    unit: str
    outputs: Any = None


class Clock:
    """The run's host clock, started with the process."""

    def __init__(self, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    @staticmethod
    def now() -> float:
        return time.perf_counter()


@dataclasses.dataclass
class Run:
    """One run of a cell: what a driver, a check and a metric reader see."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    clock: Clock
    inputs: dict = dataclasses.field(default_factory=dict)
    state: dict = dataclasses.field(default_factory=dict)
    setup_s: float | None = None
    tracer: Any = None  # trace.Tracer while a traced window runs

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def args(self) -> dict:
        return self.cell.workload.get("driver_args", {})

    @property
    def limits(self) -> dict:
        return self.cell.workload["limits"]

    def mark(self, name: str) -> None:
        """A zero-length marker in the trace (``rb::<name>``)."""
        if self.tracer is not None:
            self.tracer.mark(name)


def forbidden_modules(mods=None) -> list[str]:
    """Loaded modules whose top-level name, whole, is one of FORBIDDEN."""
    mods = sys.modules if mods is None else mods
    return sorted({m for m in list(mods) if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: list[Compared],
                breakdown: dict | None = None) -> str:
    """The last line of standard output; the compared numbers come last."""
    line: dict = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in compared}
    return json.dumps(line)
