"""Build and load the port's CUDA sources.

Each library is one ``nvcc`` call over sources in ``esm_tpu_torch/csrc``,
producing a shared library with a plain C interface that is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds); libraries asked
for together are built by concurrent ``nvcc`` processes. The output goes to
``build/kernels/`` beside the package (``ESM_TPU_TORCH_BUILD_DIR`` overrides
it), named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads what is there. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Every kernel library of the port: name -> its sources under csrc/.
LIBRARIES = {
    "esm_flash_attention": ["flash_attention.cu"],          # K1
    "esm_flash_attention_bwd": ["flash_attention_bwd.cu"],  # K2
    "esm_triangle_attention": ["triangle_attention.cu"],    # K6
    "esm_triangle_mul": ["triangle_mul.cu"],                # K7, K8
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds spent in nvcc and its ptxas report, per library built by this process
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("ESM_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _output(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / s for s in sources]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_libraries(specs: Mapping[str, Sequence[str]]) -> Dict[str, ctypes.CDLL]:
    """Build each library ``name -> sources`` (file names under csrc/) that is
    not built yet, all ``nvcc`` processes at once, and load them. Raises with
    nvcc's output when a build fails. A library loaded before is returned
    without touching the sources (this runs before every kernel launch)."""
    with _lock:
        outputs = {name: _output(name, sources) for name, sources in specs.items()
                   if name not in _libs}
        started = {}
        for name, out in outputs.items():
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in specs[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            started[name] = (cmd, proc, tmp, out, time.perf_counter())
        failed = []
        for name, (cmd, proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, out in outputs.items():
            _libs[name] = ctypes.CDLL(str(out))
        return {name: _libs[name] for name in specs}


def load_library(name: str) -> ctypes.CDLL:
    """One library of :data:`LIBRARIES`, built at first use."""
    return load_libraries({name: LIBRARIES[name]})[name]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (or load) every library of :data:`LIBRARIES` now, all ``nvcc``
    processes at once."""
    return load_libraries(LIBRARIES)
