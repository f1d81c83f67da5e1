"""The result's line, the harness's refusals, and BENCHMARK.json against the
benchmark's contract."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT

from yardstick import runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", ["mixtral-prefill", "jamba-decode"])
@pytest.mark.parametrize("trace", [0, 1])
def test_line_schema(smoke_root, cell, trace):
    c = runner.load_cell(cell, root=smoke_root)
    result, lines = runner.run(c, 2**31 + 5, 0.3, bool(trace), torch.device("cpu"), time.perf_counter())
    assert list(result)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert ("mfu.prefill" if "prefill" in cell else "mfu.decode") in result["metrics"]
    else:
        assert set(result["metrics"]) == names
        assert "setup_s" in result["metrics"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert lines[-len(result["compared"]):] == [
        f"compared {k}: {v['value']!r} limit {v['limit']!r}" for k, v in result["compared"].items()]
    json.dumps(result)


def _run_py(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mixtral-prefill",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run_py(ROOT)
    assert p.returncode == 2 and p.stdout == ""


def test_benchmark_and_paths_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_workload_is_refused():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "no-such-cell", "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_a_config_that_differs_is_refused():
    from yardstick.program import ConfigMismatch, Program

    cell = runner.load_cell("mixtral-prefill")
    conf = json.loads(json.dumps(cell.conf))
    conf["intermediate_size"] = 14000
    with pytest.raises(ConfigMismatch, match="d_ff_expert"):
        Program(conf, runner.shape_of(conf))
    conf = json.loads(json.dumps(runner.load_cell("jamba-prefill").conf))
    conf["attn_layer_offset"] = 3
    with pytest.raises(ConfigMismatch, match="layers"):
        Program(conf, runner.shape_of(conf))


def test_every_cell_loads_and_the_program_takes_its_config():
    from yardstick.program import Program

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = runner.load_cell(w["name"])
        Program(cell.conf, cell.shape)
        assert cell.limits is not None and cell.limits["compare"]
        assert cell.per_layer and cell.end_to_end


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24
    # the check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in names
            names.add(entry["name"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("perfbench/")
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "expert" in k for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(conf["source_values"])
        assert conf["source"] == c["source"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and any(w["name"] in m["workloads"] for m in bench["per_layer"])
