"""Readings that a cell's limits are set from (``perfbench/limits/<cell>.json``).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s>

In one process, for each seed: the cell's set-up, a window of ``--seconds``
at the cell's own load, then the check of what it served against the plain
reference (the program's readings). For each control seed, also the
precision control: the reference itself computed with float8 operands, its
first choice at every position judged by the float32 reference (the
control's readings). One JSON line a seed. The benchmark's own runs never
run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from yardstick import plain, runner

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "workload": args.workload}), flush=True)
    cell = runner.load_cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s] + sorted(control)
    for seed in seeds:
        t0 = time.perf_counter()
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            driver = runner.setup(cell, seed, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            driver.run(args.seconds)
            e2e = driver.end_to_end()
            peak = torch.cuda.max_memory_allocated()
            driver.free()
            gc.collect()
            torch.cuda.empty_cache()
            plain.fp32_matmuls()
            t2 = time.perf_counter()
            checked = driver.check(cell.reference, control=seed in control)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        row = {"seed": seed, **checked, "e2e": e2e, "memory_peak_bytes": peak,
               "setup_s": t1 - t0, "setup_phases": driver.setup_phases, "window_s": driver.window_s,
               "check_s": t3 - t2,
               "attempted": driver.attempted()}
        print(json.dumps(row), flush=True)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    found = runner.forbidden_modules()
    print(json.dumps({"forbidden_modules": found, "total_s": time.perf_counter() - T_START}))
    return 0 if not found else 3


if __name__ == "__main__":
    sys.exit(main())
