"""Run one cell of the benchmark of the PyTorch/CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. With ``--trace 0`` the last line of standard output holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice; ``correct`` says whether what the window served agrees with
the configuration's plain reference. The numbers compared, each beside its
limit, are the last lines on standard error and the line's last key.

Exit codes: 2 no card (or too few) or no such cell, 3 a forbidden module was
loaded (JAX or the JAX package), 4 the program's config differs from the
configuration's file; any other failure raises (1). No result is printed
then.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from yardstick import runner
    from yardstick.program import ConfigMismatch

    try:
        cell = runner.load_cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result, lines = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda"), T_START)
    except ConfigMismatch as e:
        print(f"refused: {e}", file=sys.stderr)
        return 4
    found = runner.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
