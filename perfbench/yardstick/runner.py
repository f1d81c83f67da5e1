"""One run of one cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (``perfbench/configs/<config>.json``, with its
plain reference ``perfbench/reference/<config>.py``) and a traffic mix
(``perfbench/traffic/<mix>.json``); the per-layer metrics that list it are
read by ``perfbench/metrics/<metric>.py``, and the limits of its check are in
``perfbench/limits/<cell>.json``. Nothing here names a cell, a configuration
or a metric.

The run: set-up (the program's config, the seeded weights, the traffic, a
warm-up of the cell's own shapes), the measured window, the device's peak
memory, then the program's state freed and the check against the reference,
and last, in a traced run, the per-layer readers (the K4 bound counts the
rows that the check's routing kept). ``setup_s`` runs from the start of the
process to the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

from yardstick.model import Shape, shape_of

__all__ = ["ROOT", "Cell", "load_cell", "load_module", "run", "forbidden_modules", "FORBIDDEN"]

ROOT = Path(__file__).resolve().parents[2]  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names, compared whole


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: Dict[str, Any]
    shape: Shape
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    reference: ModuleType
    readers: Dict[str, ModuleType]
    limits: Optional[Dict[str, Any]]


def load_module(path: Path) -> ModuleType:
    """A file under ``perfbench`` as a module (its name may hold dots and dashes)."""
    name = "perfbench_" + "".join(c if c.isalnum() else "_" for c in path.as_posix())
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    conf = json.loads((root / config["file"]).read_text())
    here = root / "perfbench"
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits_file = here / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        conf=conf,
        shape=shape_of(conf),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=e2e,
        per_layer=per_layer,
        reference=load_module(here / "reference" / f"{w['config']}.py"),
        readers={m["name"]: load_module(here / "metrics" / f"{m['name']}.py") for m in per_layer},
        limits=json.loads(limits_file.read_text()) if limits_file.exists() else None,
    )


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def compare(numbers: Dict[str, float], limits: Dict[str, Any]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each compared number against its limit (a number at or under it passes)."""
    compared = {k: {"value": numbers[k], "limit": float(v["limit"])}
                for k, v in limits["compare"].items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def setup(cell: Cell, seed: int, device):
    """The program, its seeded weights, the traffic and the warmed-up driver."""
    from yardstick.program import Program
    from yardstick.serve import make_driver
    from yardstick.traffic import make_traffic
    from yardstick.weights import make_weights

    import torch

    def done(name):  # the phase's seconds, its work finished on the device
        if device.type == "cuda":
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - sum(phases.values()) - t0

    phases: Dict[str, float] = {}
    t0 = time.perf_counter()
    program = Program(cell.conf, cell.shape)
    done("program")
    weights = make_weights(program.abstract, seed, device, cell.shape.d)
    done("weights")
    traffic = make_traffic(cell.traffic, seed, cell.shape.vocab, device)
    driver = make_driver(cell.traffic["kind"], program, weights, traffic, cell.shape, cell.traffic,
                         seed, device)
    done("traffic")
    driver.warm_up()
    done("warm_up")
    driver.setup_phases = phases
    return driver


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        limits: Optional[Dict[str, Any]] = None) -> Tuple[Dict[str, Any], List[str]]:
    """(the result's line as a dict, the lines of compared numbers)."""
    import torch

    from yardstick import plain
    from yardstick.trace import Tracer

    limits = limits or cell.limits
    if limits is None:
        raise FileNotFoundError(f"perfbench/limits/{cell.name}.json: the cell has no limits")
    cuda = device.type == "cuda"
    with torch.inference_mode():
        driver = setup(cell, seed, device)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        tracer = Tracer(torch) if trace else None
        driver.run(seconds, tracer)
        if tracer is not None:
            tracer.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        dev: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu",
                               "kind": torch.cuda.get_device_name() if cuda else "cpu",
                               "count": cell.chips, "memory_peak_bytes": int(peak)}
        metrics: Dict[str, Dict[str, Any]] = {}
        breakdown = None
        notes = [f"set-up seconds: {setup_s!r}, of which {driver.setup_phases}; "
                 f"window {driver.window_s!r} s, {driver.attempted()} attempted"]
        if trace:
            tr = tracer.read()
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        else:
            e2e = driver.end_to_end()
            e2e["setup_s"] = setup_s
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end}
        attempted = driver.attempted()
        driver.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        plain.fp32_matmuls()
        checked = driver.check(cell.reference)
        if trace:  # the readers, once the check has routed the traced tokens
            ctx = SimpleNamespace(kind=driver.kind, shape=cell.shape, conf=cell.conf, trace=tr,
                                  window_s=driver.window_s, work=_work(driver),
                                  traced=driver.traced, routed=driver.traced_routing(),
                                  batch=getattr(driver.traffic, "streams", 1),
                                  launches=driver.launches, notes=[])
            for m in cell.per_layer:
                value = cell.readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            notes += ctx.notes + [f"launches in the traced slice: {driver.launches}"]
            del tr
    correct, compared = compare(checked["numbers"], limits)
    result: Dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": 0,
                              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {"requests": checked["requests"], "positions": checked["positions"],
                         **{k: v for k, v in checked["numbers"].items() if k not in compared}}
    result["compared"] = compared
    lines = notes + [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in compared.items()]
    return result, lines


def _work(driver) -> List[int]:
    """Every request's prompt length, or every decode step's attended keys."""
    if driver.kind == "prefill":
        return [r["length"] for r in driver.requests]
    return list(driver.keys)
