"""Masked-LM training, as ``cli.pretrain`` runs it: ``train_step_corrupted``
with AdamW, one batch of fixed-length crops a step, the loss read back every
``log_every`` steps, closed loop until the window ends.

Traffic parameters (``traffic/<name>.json``): ``batch`` rows of ``length``
tokens (BOS, residues, EOS), BERT masking (``mask_prob`` of the residues;
``mask_token`` of them to <mask>, ``random_token`` to a random residue, the
rest kept), the optimizer's settings (``optimizer``), the program's
training options (``program``: remat), ``first_steps`` (the steps set-up
runs and the check follows) and ``reference_rows`` (rows a reference pass).

Every step's rows and corruption are drawn on the device from the seed and
the step's number, so the rows of every step differ, and the check draws
the same ones.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from ..harness import Window
from ..reference import esm2 as ref


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.p = cell.traffic
        self.span = lambda name: contextlib.nullcontext()

    def feed(self, step: int):
        """(corrupted, targets, target mask) of one step, on the device."""
        p, dev = self.p, self.cell.device
        g = torch.Generator(device=dev).manual_seed(self.cell.stream(1, step))
        b, t = p["batch"], p["length"]
        amino = torch.tensor([ref.IDX[a] for a in ref.AMINO], device=dev)
        tokens = torch.cat([torch.full((b, 1), ref.CLS, device=dev),
                            amino[torch.randint(0, 20, (b, t - 2), generator=g, device=dev)],
                            torch.full((b, 1), ref.EOS, device=dev)], dim=1)
        residue = torch.zeros(b, t, dtype=torch.bool, device=dev)
        residue[:, 1:-1] = True
        chosen = (torch.rand(b, t, generator=g, device=dev) < p["mask_prob"]) & residue
        kind = torch.rand(b, t, generator=g, device=dev)
        swap = amino[torch.randint(0, 20, (b, t), generator=g, device=dev)]
        corrupted = torch.where(chosen & (kind < p["mask_token"]), ref.MASK, tokens)
        corrupted = torch.where(chosen & (kind >= p["mask_token"])
                                & (kind < p["mask_token"] + p["random_token"]), swap, corrupted)
        return corrupted, tokens, chosen

    def setup(self) -> None:
        c, p = self.cell, self.p
        self.readings = None
        w = c.family.weights(c.config, c.stream(0), c.device)
        if c.variant == "fp8":  # the reference in fp8 takes the program's place
            self.readings = reference_steps(self, w, mm=ref.fp8_matmul)
            return
        if c.variant == "half":  # a fault: each step's mean over half of the batch
            self.readings = reference_steps(self, w, rows=p["batch"] // 2)
            return
        from esm_tpu_torch import training

        self.training = training
        handle = c.family.program(dict(c.config, **p["program"]), w, c.device)
        del w
        self.model, self.cfg = handle.model, handle.cfg
        o = p["optimizer"]
        self.tx = training.make_optimizer(o["lr"], weight_decay=o["weight_decay"],
                                          warmup_steps=o["warmup_steps"],
                                          total_steps=o["total_steps"])
        self.state = training.init_state(self.model, self.tx)
        params = dict(self.model.named_parameters())
        start = {n: q.detach().to("cpu", copy=True) for n, q in params.items()}
        losses, counts, first = [], [], {}
        for step in range(p["first_steps"]):  # through the window's own call and feed
            metrics = self._step(step)
            losses.append(float(metrics["loss"]))
            counts.append(float(metrics["num_masked"]))
            if step == 0:  # the first gradient as AdamW got it: mu / (1 - b1)
                first = {n: (m.float() / (1 - self.tx.b1)).norm().item()
                         for n, m in self.state.opt_state.mu.items()}
        change = {n: (q.detach() - start[n].to(q.device)).norm().item()
                  for n, q in params.items()}
        self.readings = {"losses": losses, "counts": counts, "first": first, "change": change}

    def _step(self, step: int):
        corrupted, targets, mask = self.feed(step)
        self.state, metrics = self.training.train_step_corrupted(
            self.state, self.cfg, self.tx, corrupted, targets, mask)
        return metrics

    def window(self, seconds: float, tracer) -> Window:
        from esm_tpu_torch.kernels import flash_attention as fa

        if self.readings is not None and not hasattr(self, "state"):
            return Window(metrics={}, attempted=0, failed=0, seconds=0.0)
        p, w = self.p, self.cell.workload["trace"]
        bwd = fa.flash_attention_bwd
        before = {}

        after = []  # (time, steps) once the trace has closed

        def close(items):
            tracer.end()
            tracer.items = items
            tracer.counters["k2_dq"] = bwd.launches_dq - before["dq"]
            tracer.counters["k2_dkv"] = bwd.launches_dkv - before["dkv"]
            after.append((time.perf_counter(), n))

        step = p["first_steps"]
        n = 0
        t0 = time.perf_counter()
        # the trace, and two steps after it that run untraced, always run
        least = w["from_item"] + w["items"] + 2 if tracer.enabled else 1
        while n < least or time.perf_counter() < t0 + seconds:
            if n == w["from_item"]:
                tracer.begin()
                before.update(dq=bwd.launches_dq, dkv=bwd.launches_dkv)
            with tracer.span("bench.train.step"):
                metrics = self._step(step)
            step += 1
            n += 1
            if step % p["log_every"] == 0:
                with tracer.span("bench.train.log"):
                    float(metrics["loss"])
            if n == w["from_item"] + w["items"] and tracer.active:
                close(w["items"])
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        if tracer.active:
            close(n - w["from_item"])
        tokens = n * p["batch"] * p["length"]
        info = {"steps": n}
        if after and n > after[0][1]:
            info["untraced"] = (n - after[0][1], t_end - after[0][0])
        return Window(metrics={"train_tokens_per_s": tokens / (t_end - t0)}, attempted=n,
                      failed=0, seconds=t_end - t0, info=info)

    def release(self) -> None:
        for name in ("state", "model", "tx"):
            self.__dict__.pop(name, None)

    def check(self) -> Dict[str, float]:
        """The first steps' losses, first gradients and parameter change
        against the plain reference's, which runs the same steps in float32."""
        c = self.cell
        w = c.family.weights(c.config, c.stream(0), c.device)
        want = reference_steps(self, w)
        got = self.readings
        gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
        # the masked positions each step's loss was taken over, against the batch's
        count = max(abs(a - b) / b for a, b in zip(got["counts"], want["counts"]))
        leaves = sorted(want["first"])
        g_med = _median([want["first"][n] for n in leaves])
        grad = max(abs(got["first"][n] - want["first"][n]) / max(want["first"][n], g_med)
                   for n in leaves)
        # leaves the reference's first gradient leaves at rounding (a key bias
        # under softmax, the unused contact head) move by round-off alone
        moved = [n for n in leaves if want["first"][n] >= 1e-3 * g_med]
        d_med = _median([want["change"][n] for n in moved])
        change = max(abs(got["change"][n] - want["change"][n]) / max(want["change"][n], d_med)
                     for n in moved)
        return {"train_grad_gap": grad, "train_change_gap": change, "train_count_gap": count,
                "train_loss_gap": max(gaps), "train_loss1_gap": gaps[0]}


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def reference_steps(drv: Driver, w: Dict[str, torch.Tensor], mm=torch.matmul,
                    rows: int = None) -> dict:
    """The first steps of the plain reference from the weights ``w``:
    each step's loss over the batch's first ``rows`` rows (all by default;
    passes of ``reference_rows`` rows, their NLL sums added and divided once
    by the masked count), the first gradient's norm by leaf, and each leaf's
    change over the steps."""
    p, cfg = drv.p, drv.cell.config
    leaves = [n for n in w if not n.endswith("inv_freq") and n != "lm_head.weight"]
    params = {n: w[n].clone().requires_grad_() for n in leaves}
    state = {"count": 0, "mu": {n: torch.zeros_like(q) for n, q in params.items()},
             "nu": {n: torch.zeros_like(q) for n, q in params.items()}}
    losses, counts, first = [], [], {}
    with ref.float32_exact():
        for step in range(p["first_steps"]):
            corrupted, targets, mask = drv.feed(step)
            full = dict(params, **{"lm_head.weight": params["embed_tokens.weight"]})
            full.update({n: w[n] for n in w if n.endswith("inv_freq")})
            for q in params.values():
                q.grad = None
            nll = count = 0.0
            for r in range(0, rows or p["batch"], p["reference_rows"]):
                part = slice(r, r + p["reference_rows"])
                s, k = ref.mlm_sums(full, cfg, corrupted[part], targets[part], mask[part], mm)
                s.backward()
                nll, count = nll + s.item(), count + k.item()
            grads = {n: (torch.zeros_like(q) if q.grad is None else q.grad) / count
                     for n, q in params.items()}
            losses.append(nll / count)
            counts.append(count)
            if step == 0:
                first = {n: g.norm().item() for n, g in grads.items()}
            ref.adamw_update(params, grads, state, p["optimizer"])
    change = {n: (params[n].detach() - w[n]).norm().item() for n in leaves}
    return {"losses": losses, "counts": counts, "first": first, "change": change}
