"""The seven checked-in sweep baselines through the port's CLI, on the CPU.

``python -m repro_torch.sweep <grid> --scale 0.1 --check-baseline
benchmarks/baselines/<file>.jsonl`` must exit 0 for every file (518 rows:
each baseline hash found among the rebuilt cells, each result within rtol
1e-9), as ``python -m repro.sweep`` does for the reference.  On the same
artifact both packages' aggregates give the same rows, and ``smoke``'s
artifact is the reference's, byte for byte.  ``chip_smoke.py``'s
``sweep_baselines`` phase runs the same seven on the card machine.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sweep_baselines.py``
(~75 s serial on two worker processes a file).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import repro.sweep.grids as RG
import repro_torch.sweep.grids as PG
from repro_torch.sweep.__main__ import main

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"
# grid -> its checked-in file and row count
FILES = {
    "smoke": ("smoke_sweep.jsonl", 32),
    "scenario_matrix": ("scenario_matrix.jsonl", 24),
    "repartition_policies": ("repartition_policies.jsonl", 120),
    "repartition_modes": ("repartition_modes.jsonl", 288),
    "fleet_scaling": ("fleet_scaling.jsonl", 16),
    "dispatchers": ("dispatchers.jsonl", 14),
    "serving_matrix": ("serving_matrix.jsonl", 24),
}
WORKERS = 2


@pytest.mark.parametrize("grid", list(FILES))
def test_cli_check_baseline_passes(grid, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # no artifacts/dqn_params.npz: the baselines' five families
    fname, n_rows = FILES[grid]
    rc = main([grid, "--scale", "0.1", "--workers", str(WORKERS), "--device", "cpu",
               "--cache-dir", str(tmp_path / "cache"), "--artifacts-dir", str(tmp_path / "art"),
               "--check-baseline", str(BASELINES / fname)])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert f"matches baseline {BASELINES / fname}" in err
    records = [json.loads(x) for x in (tmp_path / "art" / f"{grid}.jsonl").read_text().splitlines()]
    assert len(records) == n_rows
    cells, results = [r["cell"] for r in records], [r["result"] for r in records]
    assert PG.GRIDS[grid].aggregate(cells, results) == RG.GRIDS[grid].aggregate(cells, results)
    if grid == "smoke":
        RG.run_grid("smoke", scale=0.1, cache=False, artifacts_dir=str(tmp_path / "ref"))
        assert (tmp_path / "art" / "smoke.jsonl").read_bytes() == (tmp_path / "ref" / "smoke.jsonl").read_bytes()
