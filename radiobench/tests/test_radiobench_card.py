"""The benchmark on the card: a short cell end to end, and each cell's
control, which has to come out not correct.  Marked ``cuda``; they skip
without a card.

    python -m pytest radiobench/tests/test_radiobench_card.py -q

The controls, at the cells' own sizes on three seeds:

- the FM cells: the reference chain in bfloat16 (planes, taps, filter
  and discriminator) in the program's place, held to the cell's limit
  on the widest gap to the float64 chain;
- the AX.25 cells: the receiver with its frame check's bytes kept
  (``keep_checksum``: frames delivered unverified), which breaks the
  configuration's guarantee that what is delivered was sent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from radiobench.harness import ROOT, load_cell, manifest
from radiobench.reference import fm_chain
from radiobench.run import run_cell

SEEDS = (2_300_000_011, 2_300_000_012, 2_300_000_013)


def cells_checked_by(check: str) -> list[str]:
    return [w["name"] for w in manifest()["workloads"]
            if load_cell(w["name"]).check == check]


@pytest.mark.cuda
def test_a_short_cell_runs_end_to_end(card, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), HOME=str(tmp_path))
    p = subprocess.run(
        [sys.executable, "-m", "radiobench.run", "--workload", "fm_rtl.capture",
         "--seed", str(SEEDS[0]), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"setup_s", "msps"} <= set(line["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells_checked_by("fm_chain"))
def test_fm_control_in_bfloat16_is_not_correct(card, name):
    for seed in SEEDS:
        res = run_cell(load_cell(name), seed, 1.0, False, card)
        assert res["correct"]
        control = fm_chain.judge(res["run"], res["window"], torch.bfloat16)
        assert not all(c.ok for c in control), [(c.name, c.value) for c in control]


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells_checked_by("ax25_frames"))
def test_ax25_control_unverified_frames_is_not_correct(card, name):
    for seed in SEEDS:
        cell = load_cell(name)
        cell.workload["driver_args"]["keep_checksum"] = True
        res = run_cell(cell, seed, 1.0, False, card)
        assert not res["correct"]
