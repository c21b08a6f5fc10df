"""Structure prediction, as ``esm-fold`` runs it: one chain at a time through
``ESMFoldHandle.infer``, its coordinates and confidences read back to the
host, closed loop, one fold after another until the window ends.

Traffic parameters (``traffic/<name>.json``): ``length`` (residues a
chain). Each fold gets a new sequence, uniform over the 20 amino acids,
drawn from the seed; a fixed length keeps every fold's cost equal.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from ..harness import Window
from ..reference import esm2 as ref_esm2
from ..reference import esmfold as ref


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.traffic
        self.span = lambda name: contextlib.nullcontext()

    def sequence(self, k: int) -> str:
        rng = np.random.default_rng(self.cell.stream(1, k))
        return "".join(ref_esm2.AMINO[i] for i in rng.integers(0, 20, self.p["length"]))

    def setup(self) -> None:
        c = self.cell
        state = c.family.weights(c.config, c.stream(0), c.device)
        self.handle = c.family.program(c.config, state, c.device)
        if c.variant == "fp8":
            self.handle = ReferenceFold(state, c.config)
        del state
        # the fold the check follows, drawn from the seed among the window's first
        self.sampled = int(np.random.default_rng(c.stream(2)).integers(
            0, c.workload["check"]["among_first"]))
        self.results = []  # (sequence index, its outputs on the host)
        self._fold(2 ** 32 - 1)  # warm-up, a sequence the window never folds
        self.results.clear()

    def _fold(self, k: int) -> None:
        with self.span("bench.fold.infer"):
            out = self.handle.infer([self.sequence(k)])
        with self.span("bench.fold.readback"):
            got = {"positions": out["positions"][-1][0].cpu(), "plddt": out["plddt"][0].cpu(),
                   "ptm": out["ptm"][0].cpu(), "mean_plddt": out["mean_plddt"][0].cpu()}
            if k == self.sampled:  # the trunk's output, for the check's two stages
                got.update(s_s=out["s_s"][0].cpu(), s_z=out["s_z"][0].cpu())
            self.results.append((k, got))

    def window(self, seconds: float, tracer) -> Window:
        from esm_tpu_torch.kernels import flash_attention as fa
        from esm_tpu_torch.kernels import triangle_attention as ta

        w = self.cell.workload["trace"]
        self.span = tracer.span
        t0 = time.perf_counter()
        k = 0
        before = {}

        after = []  # (time, folds) once the trace has closed

        def close(items):
            tracer.end()
            tracer.items = items
            tracer.counters["k1"] = fa.flash_attention.launches - before["k1"]
            tracer.counters["k6"] = ta.triangle_attention_fused.launches - before["k6"]
            after.append((time.perf_counter(), k))

        # the trace, a fold after it that runs untraced, and the sampled fold always run
        least = max(w["from_item"] + w["items"] + 1 if tracer.enabled else 1, self.sampled + 1)
        while k < least or time.perf_counter() < t0 + seconds:
            if k == w["from_item"]:
                tracer.begin()
                before.update(k1=fa.flash_attention.launches,
                              k6=ta.triangle_attention_fused.launches)
            self._fold(k)
            k += 1
            if k == w["from_item"] + w["items"] and tracer.active:
                close(w["items"])
        t_end = time.perf_counter()
        if tracer.active:
            close(k - w["from_item"])
        info = {"folds": k}
        if after and k > after[0][1]:
            info["untraced"] = (k - after[0][1], t_end - after[0][0])
        return Window(metrics={"fold_s": (t_end - t0) / k}, attempted=k, failed=0,
                      seconds=t_end - t0, info=info)

    def release(self) -> None:
        del self.handle

    def check(self) -> Dict[str, float]:
        """The sampled fold against the plain reference in float32, in two
        stages. The whole fold again: the relative errors of the trunk's
        single and pair states, and (read, not held to a limit: the recycled
        distance bins make them swing) the CA-RMSD, with no superposition
        since both start from the identity frames, and the gaps in mean and
        per-residue pLDDT and in pTM. The structure module and heads alone,
        on the program's own trunk output: the CA-RMSD, and the gaps in pTM
        and in mean and per-residue pLDDT."""
        c = self.cell
        k, got = self.results[self.sampled]
        seq = self.sequence(k)
        w = c.family.weights(c.config, c.stream(0), c.device)
        with torch.no_grad(), ref_esm2.float32_exact():
            want = ref.fold(w, c.config, [seq])[0]
            stage = ref.structure(w, c.config, got["s_s"].to(c.device),
                                  got["s_z"].to(c.device), seq)

        def ca_rmsd(a, b):
            return (a[:, 1].to(c.device) - b[:, 1]).pow(2).sum(-1).mean().sqrt().item()

        def rel_err(key):
            a, b = got[key].to(c.device).float(), want[key]
            return ((a - b).norm() / b.norm()).item()

        def plddt_res_gap(ref_out):
            gap = got["plddt"].mean(-1).to(c.device) - ref_out["plddt"].mean(-1)
            return gap.abs().max().item()

        return {
            "fold_single_rel_err": rel_err("s_s"),
            "fold_pair_rel_err": rel_err("s_z"),
            "fold_sm_ca_rmsd": ca_rmsd(got["positions"], stage["positions"]),
            "fold_sm_plddt_gap": abs(got["mean_plddt"].item() - stage["mean_plddt"].item()),
            "fold_sm_plddt_res_gap": plddt_res_gap(stage),
            "fold_sm_ptm_gap": abs(got["ptm"].item() - stage["ptm"].item()),
            "fold_ca_rmsd": ca_rmsd(got["positions"], want["positions"]),
            "fold_plddt_gap": abs(got["mean_plddt"].item() - want["mean_plddt"].item()),
            "fold_plddt_res_gap": plddt_res_gap(want),
            "fold_ptm_gap": abs(got["ptm"].item() - want["ptm"].item()),
        }


class ReferenceFold:
    """The control in the program's place: the plain reference fold one step
    below each part's stated precision, the LM's and the trunk's matrix
    products' operands rounded to fp8 (they run in bf16), the structure
    module's and the heads' products in TF32 (they run in float32)."""

    def __init__(self, w, cfg):
        self.w, self.cfg = w, cfg

    @torch.no_grad()
    def infer(self, sequences):
        with ref_esm2.float32_exact():
            out = ref.fold(self.w, self.cfg, sequences, mm=ref_esm2.fp8_matmul, sm_tf32=True)[0]
        return {"positions": out["positions"][None, None], "plddt": out["plddt"][None],
                "ptm": out["ptm"][None], "mean_plddt": out["mean_plddt"][None],
                "s_s": out["s_s"][None], "s_z": out["s_z"][None]}
