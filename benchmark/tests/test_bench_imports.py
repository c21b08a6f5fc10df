"""What the benchmark loads: never JAX or the JAX package (compared by whole
top-level module names: ``esm_tpu_torch`` is not ``esm_tpu``), and the
plain references nothing of the program."""

import subprocess
import sys

from benchmark import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
import importlib, pkgutil
import benchmark, benchmark.harness as h, benchmark.tracing
for pkg in ("drivers", "families", "reference", "counts"):
    mod = importlib.import_module("benchmark." + pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(f"benchmark.{{pkg}}.{{info.name}}")
for m in h.spec()["per_layer"]:
    h.reader(m["name"])
{extra}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

PORT = """
import esm_tpu_torch.training, esm_tpu_torch.pretrained, esm_tpu_torch.runtime
import esm_tpu_torch.models.esmfold.esmfold, esm_tpu_torch.io.convert
import esm_tpu_torch.kernels.flash_attention, esm_tpu_torch.kernels.triangle_attention
import esm_tpu_torch.data.fasta
"""


def _top_level(extra: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                                             extra=extra)],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_no_jax_with_the_port():
    names = _top_level(PORT)
    assert "esm_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_references_import_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {str(harness.ROOT)!r}); "
        "import benchmark.reference.esm2, benchmark.reference.esmfold; "
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert not names & {"esm_tpu_torch", *harness.FORBIDDEN}
