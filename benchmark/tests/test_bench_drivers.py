"""Each driver runs its whole loop at a tiny size on the CPU (set-up, the
window, the traced window and its readers, the check against the plain
reference) and gives the result line's keys; the real command refuses to
run without a card, and the harness finds a new cell, traffic mix and
per-layer metric from new files alone."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_driver_runs_tiny(name, trace):
    result, checks, _ = harness.run_cell(name, 2 ** 31 + 7, 0.5, trace, device="cpu",
                                      overrides=CELLS[name])
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks" and checks
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]
        kinds = {m["name"] for m in harness.metrics_of(name, "per_layer")}
        assert set(result["metrics"]) <= kinds and result["metrics"]
    else:
        kinds = {m["name"] for m in harness.metrics_of(name, "end_to_end")}
        assert set(result["metrics"]) == kinds
    json.dumps(result)


def test_command_needs_a_card():
    """Without a CUDA card the command exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "esm2_650m.embed",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_new_cell_from_files_alone(tmp_path):
    """A later PR adds a cell, its traffic mix and a per-layer metric with new
    files and new entries only: the harness finds and runs them."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.spec()
    spec["workloads"].append({"name": "esm2_650m.embed-short", "config": "esm2_t33_650M",
                              "traffic": "embed_short", "chips": 1, "why": "short rows"})
    spec["end_to_end"][0]["workloads"].append("esm2_650m.embed-short")
    spec["per_layer"].append({"name": "embed.batches", "unit": "batches", "better": "higher",
                              "source": "host_clock", "layer": "host pipeline",
                              "moves": "embed_residues_per_s",
                              "workloads": ["esm2_650m.embed-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = harness.read_json(root / "benchmark" / "traffic" / "embed_pool16k.json")
    traffic.update(median_length=60, max_length=120)
    (root / "benchmark" / "traffic" / "embed_short.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark" / "workloads" / "esm2_650m.embed.json",
                root / "benchmark" / "workloads" / "esm2_650m.embed-short.json")
    (root / "benchmark" / "metrics" / "embed.batches.py").write_text(
        "def read(ctx):\n    return len(ctx.window.info['shapes'])\n")

    tiny = dict(CELLS["esm2_650m.embed"], traffic=dict(CELLS["esm2_650m.embed"]["traffic"],
                                                       median_length=12, max_length=24))
    result, _, _ = harness.run_cell("esm2_650m.embed-short", 3, 0.5, True, device="cpu",
                                 root=root, overrides=tiny)
    assert result["metrics"]["embed.batches"]["value"] > 0
    assert result["correct"] is True


def test_embed_mfu_reads_the_untraced_batches():
    """In a traced embedding run, ``embed.mfu`` takes the batches dispatched
    after the traced stretch and their time, not the profiled ones."""
    from benchmark.tracing import Tracer

    name = "esm2_650m.embed"
    c = harness.cell(name, 2 ** 31 + 9, "cpu", overrides=CELLS[name])
    d = harness.driver(c)
    d.setup()
    win = d.window(0.5, Tracer(True, "cpu"))
    lengths, seconds = win.info["untraced"]
    assert 0 < sum(lengths) < sum(win.info["lengths"]) and 0 < seconds < win.seconds
    ctx = harness.ReadContext(c, win, None)
    assert harness.reader("embed.mfu").read(ctx) > 0
