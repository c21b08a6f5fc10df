"""The numbers a cell's check compares, over many seeds in one process: the
readings that its limits are set from (``PERF.md`` gives them).

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 13 [--control fp8|half]

Each seed runs the cell as ``run.py`` does (weights, set-up, a window of
``--seconds``, the check against the plain reference), with the program,
or with ``--control`` something else in its place: ``fp8``, the control
(the plain reference with its matrix products' operands rounded to fp8),
or for training ``half``, the fault of a mean over half of each batch. One
JSON line a seed: every number the check read, and those compared with
their limits.
"""

import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["USE_FLAX"] = "0"


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("fp8", "half"), default=None)
    args = ap.parse_args()

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        result, checks, values = harness.run_cell(args.workload, seed, args.seconds, False,
                                                  variant=args.control or "program")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"], "readings": values,
                          "checks": result["checks"],
                          "metrics": result["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
        del result, checks, values
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
