"""The harness: finds a cell's files by name, runs its driver through set-up,
the measured window and the check, and builds the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

  * ``configs/<config>.json``: the configuration as it is run; its
    ``family`` names ``families/<family>.py`` (weights, program, reference);
  * ``traffic/<traffic>.json``: a traffic mix's parameters; its ``driver``
    names ``drivers/<driver>.py``, the general generator and loop for that
    kind of work;
  * ``workloads/<cell>.json``: the cell's correctness limits and trace span;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

A driver module exposes ``Driver(cell)`` with ``setup()``, ``window(seconds,
tracer) -> Window``, ``release()`` and ``check() -> {number: reading}``; the
cell's workload file gives the limit of each number that is compared.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "esm_tpu")


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of a run (weights, traffic, ...) drawn
    from the run's ``--seed``, whatever its size or sign."""
    words = [int(seed) % (2 ** 64)] + [int(k) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Window:
    """What a driver's window returns: its end-to-end metrics (besides
    ``setup_s`` and ``peak_mem_gb``, which the harness takes), the items
    attempted and failed, and the counts the per-layer readers use."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    seconds: float
    info: dict = field(default_factory=dict)


@dataclass
class Cell:
    name: str
    seed: int
    device: str
    config: dict
    traffic: dict
    workload: dict
    family: ModuleType
    # "program", or "fp8": the control in the program's place (the plain
    # reference with every matrix product's operands rounded to fp8); for
    # training also "half", the fault of a mean over half of each batch
    variant: str = "program"

    def stream(self, *keys: int) -> int:
        return sub_seed(self.seed, *keys)


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(name: str, seed: int, device: str, root: Path = ROOT, variant: str = "program",
         overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read;
    ``overrides`` ({"config": {...}, "traffic": {...}, "workload": {...}})
    shrink it for the CPU tests."""
    s = spec(root)
    entry = next((w for w in s["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in s["configs"] if c["name"] == entry["config"])
    over = overrides or {}
    config = _merge(read_json(root / conf["file"]), over.get("config"))
    traffic = _merge(read_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json"),
                     over.get("traffic"))
    workload = _merge(read_json(root / "benchmark" / "workloads" / f"{name}.json"),
                      over.get("workload"))
    workload["chips"] = entry["chips"]
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    return Cell(name, seed, device, config, traffic, workload, family, variant)


def driver(c: Cell):
    return importlib.import_module(f"benchmark.drivers.{c.traffic['driver']}").Driver(c)


def metrics_of(name: str, kind: str, root: Path = ROOT) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell ``name`` reports."""
    return [m for m in spec(root)[kind] if name in m.get("workloads", [name])]


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    mod_name = "benchmark.metrics." + metric.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


@dataclass
class ReadContext:
    """What a per-layer reader is given: the cell, its window, the trace."""
    cell: Cell
    window: Window
    trace: object  # tracing.TraceSummary


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, root: Path = ROOT, variant: str = "program",
             overrides: Optional[dict] = None):
    """One run of a cell: set-up, the window, the readers, the check.
    Returns (the result line's dict, the checks, every number the check read)."""
    import torch

    from .tracing import Tracer, breakdown

    t0 = time.perf_counter() if t0 is None else t0
    c = cell(name, seed, device, root, variant, overrides)
    d = driver(c)
    t_setup = time.perf_counter()
    d.setup()
    _sync(device)
    setup_s = time.perf_counter() - t0
    print(f"[{name}] set-up {setup_s:.2f} s ({t_setup - t0:.2f} s to the driver, "
          f"{setup_s - (t_setup - t0):.2f} s in it)", flush=True)

    tracer = Tracer(trace, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    win = d.window(seconds, tracer)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    summary = tracer.summary() if trace else None
    print(f"[{name}] window {win.seconds:.3f} s, {win.attempted} attempted, {win.failed} failed, "
          f"{ {k: round(v, 4) for k, v in win.metrics.items()} }", flush=True)

    result = {"correct": False, "attempted": win.attempted, "failed": win.failed}
    if trace:
        ctx = ReadContext(c, win, summary)
        metrics = {}
        for m in metrics_of(name, "per_layer", root):
            value = reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(win.metrics, setup_s=setup_s, peak_mem_gb=peak / 1e9)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in metrics_of(name, "end_to_end", root) if m["name"] in values}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": c.workload["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["device"] = dev
        result["breakdown"] = breakdown(summary)
    else:
        result["device"] = dev

    d.release()  # the program's state goes; what the check compares stays
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = d.check()
    print(f"[{name}] check {time.perf_counter() - t_check:.2f} s; read "
          + ", ".join(f"{k} {v:.6g}" for k, v in values.items()), flush=True)
    checks = [Check(k, values[k], limit) for k, limit in c.workload["limits"].items()]
    result["correct"] = bool(checks) and all(k.ok for k in checks)
    result["checks"] = {k.name: {"value": k.value, "limit": k.limit} for k in checks}
    return result, checks, values


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
