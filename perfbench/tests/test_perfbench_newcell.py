"""A cell assembled from new files alone: a configuration, its reference, a
traffic mix, limits and a per-layer metric, each a file of its own and an
entry in BENCHMARK.json. The harness finds and runs it with no edit."""

import json
import shutil
import time

import torch
from conftest import BENCH, DATA, make_root

from yardstick import runner

READER = '''"""requests_per_s.prefill: prompts served a second over the window."""


def read(ctx):
    return len(ctx.work) / ctx.window_s if ctx.kind == "prefill" else None
'''


def test_new_files_make_a_new_cell(tmp_path):
    root = make_root(tmp_path)
    pb = root / "perfbench"
    conf = json.loads((DATA / "mixtral-smoke.json").read_text())
    conf.update(name="mixtral-smoke-deep", num_hidden_layers=4, torch_dtype="float32")
    (pb / "configs" / "mixtral-smoke-deep.json").write_text(json.dumps(conf))
    shutil.copy(BENCH / "reference" / "mixtral-8x7b.py", pb / "reference" / "mixtral-smoke-deep.py")
    (pb / "traffic" / "short-pair.json").write_text(json.dumps(
        {"kind": "prefill", "lengths": [32, 48], "pool_tokens": 1024}))
    (pb / "limits" / "deep-short.json").write_text(json.dumps({"compare": {"mean_gap": {"limit": 1e-3}}}))
    (pb / "metrics" / "requests_per_s.prefill.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mixtral-smoke-deep", "source": "smoke preset",
                             "file": "perfbench/configs/mixtral-smoke-deep.json", "reduced": [],
                             "why": "CPU test"})
    bench["workloads"].append({"name": "deep-short", "config": "mixtral-smoke-deep",
                               "traffic": "short-pair", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"]:
        if "prefill_tok_s" == m["name"] or "ttft_p95_ms" == m["name"]:
            m["workloads"].append("deep-short")
    bench["per_layer"].append({"name": "requests_per_s.prefill", "unit": "requests/s", "better": "higher",
                               "source": "host_clock", "layer": "serve driver", "moves": "prefill_tok_s",
                               "workloads": ["deep-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = runner.load_cell("deep-short", root=root)
    assert cell.shape.n_layers == 4 and [m["name"] for m in cell.per_layer] == ["requests_per_s.prefill"]
    result, _ = runner.run(cell, 3, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True
    assert result["metrics"]["requests_per_s.prefill"]["value"] > 0
    result, _ = runner.run(cell, 3, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert set(result["metrics"]) == {"prefill_tok_s", "ttft_p95_ms", "setup_s"}
