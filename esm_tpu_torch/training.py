"""Masked-LM training of ESM-2: single device, full parameters.

Port of esm_tpu/training.py:22-246 and :501-516: BERT-style 15% masking
(80% <mask> / 10% random residue / 10% kept), cross-entropy on the masked
positions, AdamW with a warmup-cosine schedule, exact gradient accumulation
and masked-perplexity evaluation.

What differs from the JAX package, and why:
  * The parameters live in the ``ESM2`` module (fp32 master weights) and a
    step updates them, and the optimizer moments, in place: no second copy
    of 650M parameters is made per step. ``TrainState`` holds the module.
  * ``jax.random`` keys become explicit ``torch.Generator``s: the bits
    differ from JAX's, so the corruption is tested on its own terms, and
    :func:`train_step_corrupted` takes a given corruption (the tests feed
    it JAX's).
  * The optimizer is written out here (:class:`AdamW`) in optax's order of
    operations (clip_by_global_norm, scale_by_adam with ``mu_dtype``,
    add_decayed_weights under the decay mask, scale by the schedule), so a
    step equals the optax step on the same gradients. torch.optim's AdamW
    and clip_grad_norm_ compute other roundings (and clip_grad_norm_ adds
    1e-6 to the norm).
  * adafactor (``factored=True``), LoRA and the MSA, IF1, fold, sequence-
    parallel and pipelined steps are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models import esm2


@dataclass
class AdamWState:
    count: int                    # updates applied so far
    mu: Dict[str, torch.Tensor]   # first moments (``mu_dtype``)
    nu: Dict[str, torch.Tensor]   # second moments (fp32)


@dataclass
class TrainState:
    model: esm2.ESM2              # the parameters, updated in place
    opt_state: AdamWState
    step: int


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight-decay mask for AdamW, by parameter name: the weights of the
    linear layers (esm_tpu's ">= 2-D ``kernel``"), including ``lm_head.dense``
    and the contact regression; not the token embedding (nor the LM head's
    projection, which is the embedding), layer norms or biases."""
    linear = {f"{name}.weight" if name else "weight"
              for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    return {name: name in linear and p.dim() >= 2 for name, p in model.named_parameters()}


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, total_steps):
    linear from 0 at step 0 to ``peak`` at ``warmup_steps``, then cosine decay
    to 0 at ``total_steps``."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, decay_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(schedule,
    b1=0.9, b2=0.98, eps=1e-8, weight_decay, mask=decay_mask, mu_dtype)) on a
    module's parameters and their ``.grad`` (a parameter with no gradient
    takes zeros, as under jax.grad)."""

    b1, b2, eps = 0.9, 0.98, 1e-8

    def __init__(self, learning_rate: Callable[[int], float], *, weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.mu_dtype = mu_dtype

    def init(self, model: nn.Module) -> AdamWState:
        params = dict(model.named_parameters())
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, model: nn.Module, state: AdamWState) -> None:
        """One step: the parameters and ``state`` change in place."""
        params = dict(model.named_parameters())
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = norm < self.grad_clip_norm
            grads = {n: torch.where(keep, g, (g / norm) * self.grad_clip_norm)
                     for n, g in grads.items()}
        decay = decay_mask(model) if self.weight_decay else {}
        count = state.count + 1
        # bias corrections in fp32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        step_size = -self.learning_rate(state.count)
        # b1 in the moment's dtype: with bf16 moments JAX rounds the constant
        # to bf16 before the product, and so does this
        b1 = {dt: torch.tensor(self.b1, dtype=dt) for dt in {m.dtype for m in state.mu.values()}}
        for name, p in params.items():
            g = grads[name]
            mu_prev = state.mu[name]
            mu = (1 - self.b1) * g + mu_prev * b1[mu_prev.dtype]
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if decay.get(name, False):
                u = u + self.weight_decay * p
            p.add_(step_size * u)
            state.mu[name] = mu.to(mu_prev.dtype)
            state.nu[name] = nu
        state.count = count


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    warmup_steps: int = 2000,
    total_steps: int = 100_000,
    grad_clip_norm: Optional[float] = None,
    mu_dtype: Optional[torch.dtype] = None,
    factored: bool = False,
) -> AdamW:
    """AdamW (b1 0.9, b2 0.98, eps 1e-8) with the warmup-cosine schedule
    (learning rate 0 at step 0). ``grad_clip_norm`` prepends global-norm
    clipping; ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the first moments
    in that type."""
    if factored:
        raise NotImplementedError(
            "factored=True (adafactor) is not ported yet: ROADMAP Queue 1, "
            "'make_optimizer(factored=True)'"
        )
    return AdamW(warmup_cosine_schedule(learning_rate, warmup_steps, total_steps),
                 weight_decay=weight_decay, grad_clip_norm=grad_clip_norm, mu_dtype=mu_dtype)


def init_state(model: esm2.ESM2, tx: AdamW) -> TrainState:
    return TrainState(model, tx.init(model), 0)


def mask_tokens(
    generator: torch.Generator,
    tokens: torch.Tensor,
    *,
    mask_idx: int,
    padding_idx: int,
    special_mask: torch.Tensor,
    num_standard: int = 20,
    standard_offset: int = 4,
    mask_prob: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT-style corruption. Returns (corrupted_tokens, target_mask).
    Padding positions are never selected (``padding_idx``), independent of
    whatever the caller puts in ``special_mask``. ``generator`` lives on the
    tokens' device."""
    kw = dict(generator=generator, device=tokens.device)
    eligible = ~special_mask & (tokens != padding_idx)
    selected = (torch.rand(tokens.shape, **kw) < mask_prob) & eligible
    kind = torch.rand(tokens.shape, **kw)
    random_aa = standard_offset + torch.randint(0, num_standard, tokens.shape, **kw)
    corrupted = torch.where(selected & (kind < 0.8), torch.full_like(tokens, mask_idx), tokens)
    corrupted = torch.where(selected & (kind >= 0.8) & (kind < 0.9),
                            random_aa.to(tokens.dtype), corrupted)
    return corrupted, selected


def _corrupt_batch(cfg: esm2.ESM2Config, generator: torch.Generator, tokens: torch.Tensor):
    special = (
        (tokens == cfg.padding_idx)
        | (tokens == cfg.cls_idx)
        | (tokens == cfg.eos_idx)
    )
    return mask_tokens(generator, tokens, mask_idx=cfg.mask_idx, padding_idx=cfg.padding_idx,
                       special_mask=special)


def _mlm_terms(model, cfg, corrupted, targets, target_mask):
    """Per-position masked-CE terms: (nll.w, correct.w, w), each (B, T)."""
    logits = esm2.apply(model, cfg, corrupted)["logits"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = target_mask.to(nll.dtype)
    correct = (logits.argmax(-1) == targets) * w
    return nll * w, correct, w


def mlm_loss_sums(model, cfg, corrupted, targets, target_mask) -> Tuple[torch.Tensor, dict]:
    """Unnormalised masked CE: (sum of the NLL over the masked positions,
    {"correct", "count"}). Linear in the batch, so sums from microbatches add
    exactly: the basis of gradient accumulation."""
    nll_w, correct, w = _mlm_terms(model, cfg, corrupted, targets, target_mask)
    return nll_w.sum(), {"correct": correct.sum(), "count": w.sum()}


def mlm_loss(model, cfg, corrupted, targets, target_mask) -> Tuple[torch.Tensor, dict]:
    nll_sum, aux = mlm_loss_sums(model, cfg, corrupted, targets, target_mask)
    denom = aux["count"].clamp_min(1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "acc": aux["correct"] / denom, "num_masked": aux["count"]}


def train_step_corrupted(
    state: TrainState,
    cfg: esm2.ESM2Config,
    tx: AdamW,
    corrupted: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    accum_steps: int = 1,
) -> Tuple[TrainState, dict]:
    """Loss, gradients and one optimizer update on a given corruption. With
    ``accum_steps`` > 1 the batch runs as that many sequential microbatches:
    the gradients of the unnormalised NLL sums add up and are divided once by
    the masked count, the same function of the batch as one pass. Metrics
    stay on the device."""
    if corrupted.shape[0] % accum_steps:
        raise ValueError(
            f"batch {corrupted.shape[0]} not divisible by accum_steps={accum_steps}"
        )
    model = state.model
    model.zero_grad(set_to_none=True)
    if accum_steps == 1:
        loss, metrics = mlm_loss(model, cfg, corrupted, targets, target_mask)
        loss.backward()
    else:
        nll = correct = count = 0.0
        for c, t, m in zip(corrupted.chunk(accum_steps), targets.chunk(accum_steps),
                           target_mask.chunk(accum_steps)):
            nll_sum, aux = mlm_loss_sums(model, cfg, c, t, m)
            nll_sum.backward()
            nll = nll + nll_sum.detach()
            correct = correct + aux["correct"]
            count = count + aux["count"]
        denom = count.clamp_min(1.0)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(denom)
        metrics = {"loss": nll / denom, "acc": correct / denom, "num_masked": count}
    tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    return TrainState(model, state.opt_state, state.step + 1), {
        k: v.detach() for k, v in metrics.items()
    }


def train_step(state: TrainState, cfg: esm2.ESM2Config, tx: AdamW,
               generator: torch.Generator, tokens: torch.Tensor) -> Tuple[TrainState, dict]:
    """One MLM step on a (B, T) token batch: corrupt with ``generator``, then
    :func:`train_step_corrupted`."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_corrupted(state, cfg, tx, corrupted, tokens, target_mask)


def train_step_accum(state: TrainState, cfg: esm2.ESM2Config, tx: AdamW,
                     generator: torch.Generator, tokens: torch.Tensor, *,
                     accum_steps: int) -> Tuple[TrainState, dict]:
    """:func:`train_step` over ``accum_steps`` microbatches: peak activation
    memory is that of B / accum_steps sequences, and the result is the same
    function of the batch."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_corrupted(state, cfg, tx, corrupted, tokens, target_mask,
                                accum_steps=accum_steps)


@torch.no_grad()
def eval_step(model: esm2.ESM2, cfg: esm2.ESM2Config, generator: torch.Generator,
              tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Masked-LM evaluation on one batch: the training corruption
    (deterministic given ``generator``), returning per-sequence sums
    {"nll_sum", "correct", "count"}, each (B,), so callers aggregate an exact
    masked perplexity, exp(sum nll / sum count), over any number of batches."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    nll_w, correct, w = _mlm_terms(model, cfg, corrupted, tokens, target_mask)
    return {"nll_sum": nll_w.sum(-1), "correct": correct.sum(-1), "count": w.sum(-1)}
