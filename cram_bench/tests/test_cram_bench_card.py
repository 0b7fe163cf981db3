"""Each cell at a short window on the card: a smoke of the whole run.

    python3 -m pytest cram_bench/tests -m card

on the card's machine, from the root of the repository."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    r = subprocess.run(
        [sys.executable, "cram_bench/run.py", "--workload", cell,
         "--seed", "2147483701", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"] is True, r.stderr[-3000:]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]
    if trace:
        assert out["device"]["busy_s"] > 0
