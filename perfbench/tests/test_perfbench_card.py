"""On the card: one short run of every cell through ``run.py``, as the
benchmark's check runs it (skips without a card)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT


def _cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_correct_on_the_card(cuda, cell):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "2718281828",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
