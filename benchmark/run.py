"""One run of one benchmark cell on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (weights drawn on the card from the seed, the port's
kernels loaded or built into the checkout, the cell's shapes warmed up),
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` (each number compared, with its
limit). The same numbers are the last lines of standard error. Exits
non-zero, with no result, without a CUDA card (or fewer than the cell
asks for), or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build and kernel cache of the run stays at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark import harness

    entry = next((w for w in harness.spec()["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    built = sorted(p.name for p in (ROOT / "build" / "kernels").glob("*.so"))
    print(f"[build] {len(built)} kernel libraries in build/kernels at the start"
          + ("" if built else ": this run builds them with nvcc inside its set-up"), flush=True)
    result, checks, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                         bool(args.trace), device="cuda", t0=T0)
    try:  # read after the run: its time is no part of the set-up
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi unavailable ({e})"
    print(f"[card] {card}", flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark runs the port "
              "alone)", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
