"""Fixtures of the benchmark's own tests: the harness and the program on the
path, a root holding small cells of the smoke presets, and the card check.

Run from the root of the repository: ``python -m pytest perfbench/tests``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the smoke cells: (cell, configuration file, traffic file, reference it borrows)
SMOKE = {
    "mixtral-prefill": ("mixtral-smoke", "prefill-smoke", "mixtral-8x7b"),
    "mixtral-decode": ("mixtral-smoke", "decode-smoke", "mixtral-8x7b"),
    "jamba-prefill": ("jamba-smoke", "prefill-smoke", "jamba-v0.1-52b"),
    "jamba-decode": ("jamba-smoke", "decode-smoke", "jamba-v0.1-52b"),
}
# a limit far above what the fp32 smoke program reads and far below a fault's
SMOKE_LIMITS = {"compare": {"widest_gap": {"limit": 0.05}, "mean_gap": {"limit": 1e-3},
                            "worst_request_gap": {"limit": 1e-3}}}


def make_root(tmp: Path) -> Path:
    """A checkout-like root whose BENCHMARK.json holds the four smoke cells,
    with the benchmark's own metric readers and the smoke files, the program
    in fp32."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp / "perfbench"
    for sub in ("configs", "traffic", "reference", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", pb / "metrics")
    configs = {}
    for cell, (conf, traffic, ref) in SMOKE.items():
        c = json.loads((DATA / f"{conf}.json").read_text())
        c["torch_dtype"] = "float32"
        (pb / "configs" / f"{conf}.json").write_text(json.dumps(c))
        shutil.copy(DATA / f"{traffic}.json", pb / "traffic" / f"{traffic}.json")
        shutil.copy(BENCH / "reference" / f"{ref}.py", pb / "reference" / f"{conf}.py")
        (pb / "limits" / f"{cell}.json").write_text(json.dumps(SMOKE_LIMITS))
        configs[conf] = {"name": conf, "source": "smoke preset", "file": f"perfbench/configs/{conf}.json",
                         "reduced": [], "why": "CPU test"}
    bench["configs"] = list(configs.values())
    bench["workloads"] = [{"name": cell, "config": conf, "traffic": traffic, "chips": 1, "why": "CPU test"}
                          for cell, (conf, traffic, _) in SMOKE.items()]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("smoke"))


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
