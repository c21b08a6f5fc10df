"""Training: masked-LM steps for the language models, LoRA, ESM-IF1, ESMFold.

Port of esm_tpu/training.py (:22-541 apart from the pipelined step):
BERT-style 15% masking (80% <mask> / 10% random
residue / 10% kept), cross-entropy on the masked positions, AdamW with a
warmup-cosine schedule or adafactor, exact gradient accumulation and
masked-perplexity evaluation; the MSA Transformer's step
(:func:`train_step_msa`), LoRA steps over a frozen base
(:func:`train_step_lora`, :func:`train_step_if_lora`) and ESM-IF1's
teacher-forced sequence step (:func:`train_step_if`); ESMFold's structure
fine-tuning against its frozen LM (:func:`train_step_fold`,
:func:`train_step_fold_lora`; the AF2 backbone losses of
``models/esmfold/losses.py``); the sequence-parallel step over a mesh
(:func:`train_step_seq`: ring attention, ``torch.distributed``).

What differs from the JAX package, and why:
  * The parameters live in the module (fp32 master weights, or a LoRA
    module of adapters) and a step updates them, and the optimizer state,
    in place: no second copy of the parameters is made per step.
    ``TrainState`` holds the module. A LoRA step freezes the base (no
    parameter of it gets a ``.grad``) and attaches the adapters for the
    duration of the step (esm_tpu_torch/lora.py).
  * ``jax.random`` keys become explicit ``torch.Generator``s: the bits
    differ from JAX's, so the corruption is tested on its own terms, and
    the ``*_corrupted`` steps take a given corruption (the tests feed them
    JAX's).
  * The optimizers are written out here (:class:`AdamW`, :class:`Adafactor`)
    in optax 0.2.6's order of operations, so a step equals the optax step
    on the same gradients. torch.optim's AdamW and clip_grad_norm_ compute
    other roundings (and clip_grad_norm_ adds 1e-6 to the norm).
    Adafactor's block RMS values are taken over esm_tpu's leaves, which
    stack the layers of the language models and of ESMFold's trunk
    (``io.from_jax.jax_leaf``): over one parameter's tensors in all layers.
  * ESMFold's LM is frozen in place (:func:`split_fold_params` sets its
    ``requires_grad`` off), where esm_tpu passes it to the step as a
    separate tree; the optimizers cover the parameters that require grad.
  * The sequence-parallel step keeps the parameters replicated on every
    rank and all-reduces their gradients.
  * A model sharded by ``parallel.sharding.shard_params`` trains through
    the same steps (:func:`train_step`, :func:`train_step_accum`): every
    rank passes the whole batch and keeps its rows; the NLL sums and counts
    are summed over (data, fsdp), the gradients reduce-scattered over fsdp
    by the layers' gathers and all-reduced over data, and the optimizers run
    on the shards (the global-norm clip sums every shard once; adafactor's
    row and column means and block RMS values are summed over the axes a
    tensor or a leaf is split over, so they are the whole matrix's).
    :func:`train_step_pp` is the pipelined step. A LoRA step over a sharded
    base keeps the adapters whole on every rank and sums their gradients
    over the mesh (``Sharding.sync_adapter_grads``); over a pipeline-sharded
    ESM-2 it runs the GPipe schedule with each stage's adapters. The ESM-1
    family and the MSA Transformer train on a sharded model through the
    same steps (``apply_fn``; :func:`train_step_msa`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass, fields
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from . import lora as _lora
from .io.from_jax import jax_leaf
from .models import esm2
from .ops.common import layer_norm
from .ops.heads import roberta_lm_head
from .parallel.mesh import local_shard
from .parallel.sharding import _layer_of, batch_rows, dp_sum, sharding_of


@dataclass
class AdamWState:
    count: int                    # updates applied so far
    mu: Dict[str, torch.Tensor]   # first moments (``mu_dtype``)
    nu: Dict[str, torch.Tensor]   # second moments (fp32)


@dataclass
class AdafactorState:
    count: int                     # updates applied so far
    v_row: Dict[str, torch.Tensor]  # factored parameters: per-row statistics
    v_col: Dict[str, torch.Tensor]  # factored parameters: per-column statistics
    v: Dict[str, torch.Tensor]      # the other parameters: second moments
    # on a sharded model, the mesh layout of v_row's and v_col's tensors: the
    # parameter's (in esm_tpu's (in, out) view) less the reduced dimension
    specs: Dict[str, Dict[str, tuple]] = dataclasses.field(default_factory=dict)


def tensor_fields(opt_state) -> Dict[str, Dict[str, torch.Tensor]]:
    """An optimizer state's tensor dicts by field: AdamW's ``mu``/``nu``,
    adafactor's ``v_row``/``v_col``/``v``."""
    return {f.name: getattr(opt_state, f.name) for f in fields(opt_state)
            if f.name != "specs" and isinstance(getattr(opt_state, f.name), dict)}


@dataclass
class TrainState:
    model: nn.Module              # the parameters (or a LoRA's adapters), updated in place
    opt_state: object             # AdamWState or AdafactorState
    step: int

    def opt_state_bytes(self) -> int:
        """Bytes of the optimizer's tensors (moments or factored statistics)."""
        return sum(t.numel() * t.element_size()
                   for d in tensor_fields(self.opt_state).values() for t in d.values())


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight-decay mask for AdamW, by parameter name: the weights of the
    linear layers (esm_tpu's ">= 2-D ``kernel``"), including ``lm_head.dense``
    and the contact regression; not the token embedding (nor the LM head's
    projection, which is the embedding), layer norms or biases."""
    linear = {f"{name}.weight" if name else "weight"
              for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    return {name: name in linear and p.dim() >= 2 for name, p in model.named_parameters()}


def trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters that require grad, by name: what an optimizer covers."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _grads(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's ``.grad``, zeros where it has none (as under jax.grad)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}


def _clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: Optional[float],
                         shard=None):
    """optax.clip_by_global_norm. ``shard``: the model's Sharding; the norm
    is then the whole model's, each shard counted once (a replicated
    parameter's copies are not added up)."""
    if max_norm is None:
        return grads
    if shard is not None:
        norm = torch.sqrt(shard.norm_sq(grads))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {n: torch.where(keep, g, (g / norm) * max_norm) for n, g in grads.items()}


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
    b1=0.9, b2, eps=1e-8, weight_decay, mask, mu_dtype)) on a module's
    parameters that require grad and their ``.grad`` (a parameter with no
    gradient takes zeros, as under jax.grad). The mask is
    :func:`decay_mask`, or every parameter with ``decay_all`` (optax's
    ``mask=None``)."""

    b1, eps = 0.9, 1e-8

    def __init__(self, learning_rate: Callable[[int], float], *, weight_decay: float = 0.01,
                 grad_clip_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None, b2: float = 0.98,
                 decay_all: bool = False):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.mu_dtype = mu_dtype
        self.b2 = b2
        self.decay_all = decay_all

    def init(self, model: nn.Module) -> AdamWState:
        params = trainable(model)
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, model: nn.Module, state: AdamWState) -> None:
        """One step: the parameters and ``state`` change in place."""
        params = trainable(model)
        grads = _clip_by_global_norm(_grads(params), self.grad_clip_norm, sharding_of(model))
        if not self.weight_decay:
            decay = {}
        elif self.decay_all:
            decay = dict.fromkeys(params, True)
        else:
            decay = decay_mask(model)
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


class Adafactor:
    """optax.chain(clip_by_global_norm(grad_clip_norm), adafactor(schedule,
    weight_decay_rate, weight_decay_mask=decay_mask)) with optax's defaults:
    scale_by_factored_rms (decay 0.8, eps 1e-30; a tensor is factored when
    its two largest dimensions are both at least 128), clip_by_block_rms(1),
    the learning rate, scale_by_param_block_rms (at least 1e-3),
    add_decayed_weights (after the learning rate, so not multiplied by it),
    scale(-1).

    A "block" is one esm_tpu leaf: the RMS values of the clip and of the
    parameter scale are taken over one parameter's tensors in all the
    layers that esm_tpu stacks (``io.from_jax.jax_leaf``). The factored
    statistics are per layer, over a linear's (in, out) view, as esm_tpu's
    (num_layers, in, out) leaves give them.

    On a model sharded by ``parallel.sharding.shard_params`` (esm_tpu jits
    optax over the sharded tree) the result is the whole tree's: the
    factored dimensions are chosen from the whole leaf's shape; a mean over
    a sharded dimension is a sum all-reduced over its mesh axis; a block's
    sums of squares count each shard once (a replicated tensor's copies on
    one rank only) and are summed over the mesh, pipeline stages included;
    each rank keeps the statistics of its shard (``AdafactorState.specs``
    lays them out for a checkpoint). On one rank every reduction is the
    unsharded one."""

    decay_rate, eps, min_dim_size_to_factor = 0.8, 1e-30, 128
    clipping_threshold, min_scale = 1.0, 1e-3

    def __init__(self, learning_rate: Callable[[int], float], *,
                 weight_decay_rate: Optional[float] = None,
                 grad_clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.weight_decay_rate = weight_decay_rate
        self.grad_clip_norm = grad_clip_norm

    @staticmethod
    def _layout(model: nn.Module):
        """name -> (esm_tpu leaf path, stacked, transposed) for each parameter:
        a linear's weight is esm_tpu's kernel transposed."""
        from .quantization import RAW_KERNELS

        kernels = {f"{name}.weight" if name else "weight"
                   for name, m in model.named_modules() if isinstance(m, nn.Linear)}
        out = {}
        for name, p in model.named_parameters():
            path, layer = jax_leaf(name)
            out[name] = (path, layer is not None,
                         name in kernels or name.rpartition(".")[2] in RAW_KERNELS)
        return out

    def _factored_dims(self, shape, stacked: bool):
        """optax's choice of the two largest axes, on esm_tpu's leaf shape,
        returned as axes of one layer's (view of the) tensor, or None."""
        if len(shape) < 2:
            return None
        sorted_dims = np.argsort(shape)
        if shape[sorted_dims[-2]] < self.min_dim_size_to_factor:
            return None
        d1, d0 = int(sorted_dims[-2]), int(sorted_dims[-1])
        if stacked:
            if 0 in (d1, d0):
                raise NotImplementedError("adafactor factoring over the stacked layer axis")
            d1, d0 = d1 - 1, d0 - 1
        return d1, d0

    def _plan(self, model: nn.Module):
        """name -> (leaf path, transposed, factored dims, the view's mesh spec
        or None): the whole leaf's shape on a sharded model."""
        layout = self._layout(model)
        shard = sharding_of(model)
        counts: Dict[tuple, int] = {}
        for path, _, _ in layout.values():
            counts[path] = counts.get(path, 0) + 1
        params = dict(model.named_parameters())
        plan = {}
        for name, (path, stacked, transposed) in layout.items():
            shape, spec = tuple(params[name].shape), None
            if shard is not None:
                spec = tuple(shard.specs[name]) + (None,) * (len(shape) - len(shard.specs[name]))
                shape = shard.whole_shape(name, shape)
            if transposed:
                shape, spec = shape[::-1], (spec[::-1] if spec is not None else None)
            layers = counts[path] * (shard.stages if shard is not None and stacked else 1)
            leaf_shape = ((layers,) + shape) if stacked else shape
            plan[name] = (path, transposed, self._factored_dims(leaf_shape, stacked), spec)
        return plan

    def init(self, model: nn.Module) -> AdafactorState:
        plan = self._plan(model)
        v_row, v_col, v = {}, {}, {}
        specs = {"v_row": {}, "v_col": {}, "v": {}}
        for name, p in model.named_parameters():
            _, transposed, dims, spec = plan[name]
            view = p.t() if transposed else p
            if dims is None:
                v[name] = torch.zeros_like(view)
                specs["v"][name] = spec
            else:
                d1, d0 = dims
                v_row[name] = torch.zeros_like(view.select(d0, 0))
                v_col[name] = torch.zeros_like(view.select(d1, 0))
                if spec is not None:
                    specs["v_row"][name] = spec[:d0] + spec[d0 + 1:]
                    specs["v_col"][name] = spec[:d1] + spec[d1 + 1:]
        sharded = sharding_of(model) is not None
        return AdafactorState(0, v_row, v_col, v, specs if sharded else {})

    @staticmethod
    def _mean(shard, spec, x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)`` over the whole tensor: a sum all-reduced over the
        mesh axis that splits ``dim`` (``spec``: ``x``'s layout)."""
        axis = spec[dim] if spec is not None else None
        if axis is None or shard.group[axis] is None:
            return x.mean(dim=dim, keepdim=keepdim)
        total = x.sum(dim=dim, keepdim=keepdim)
        dist.all_reduce(total, group=shard.group[axis])
        return total / (x.shape[dim] * shard.sizes[axis])

    @staticmethod
    def _block_sums(shard, leaves, updates, params):
        """Per leaf (sum of u², sum of p², whole element count): with a
        sharding, each shard counted once and the sums taken over the mesh."""
        out = {}
        for path, names in leaves.items():
            zero = torch.zeros_like(updates[names[0]].sum())
            once = [shard is None or shard.counts_once(k) for k in names]
            u_sq = sum(torch.sum(updates[k] * updates[k]) if c else zero for k, c in zip(names, once))
            p_sq = sum(torch.sum(params[k] * params[k]) if c else zero for k, c in zip(names, once))
            n = sum(params[k].numel() for k in names)
            if shard is not None:
                n = sum(math.prod(shard.whole_shape(k, params[k].shape))
                        * (shard.stages if _layer_of(k) is not None else 1) for k in names)
            out[path] = [u_sq, p_sq, n]
        if shard is not None and dist.get_world_size() > 1:
            order = sorted(out)
            sums = torch.stack([torch.stack([out[p][0], out[p][1]]) for p in order])
            dist.all_reduce(sums)
            for i, path in enumerate(order):
                out[path][:2] = sums[i, 0], sums[i, 1]
        return out

    @torch.no_grad()
    def update(self, model: nn.Module, state: AdafactorState) -> None:
        """One step: the parameters and ``state`` change in place."""
        params = dict(model.named_parameters())
        shard = sharding_of(model)
        grads = _clip_by_global_norm(_grads(params), self.grad_clip_norm, shard)
        plan = self._plan(model)
        # optax's decay rate, in fp32: 1 - (count + 1) ** -0.8
        t = np.float32(state.count + 1)
        rate = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        keep = float(np.float32(1.0) - np.float32(rate))

        # scale_by_factored_rms, per tensor (in esm_tpu's (in, out) view)
        updates = {}
        for name, p in params.items():
            _, transposed, dims, spec = plan[name]
            g = grads[name].t() if transposed else grads[name]
            g_sq = g * g + self.eps
            if dims is None:
                v = rate * state.v[name] + keep * g_sq
                state.v[name] = v
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                mean = functools.partial(self._mean, shard, spec)
                v_row = rate * state.v_row[name] + keep * mean(g_sq, d0)
                v_col = rate * state.v_col[name] + keep * mean(g_sq, d1)
                state.v_row[name], state.v_col[name] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_spec = spec[:d0] + spec[d0 + 1:] if spec is not None else None
                row_mean = self._mean(shard, row_spec, v_row, reduced_d1, keepdim=True)
                row_factor = (v_row / row_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            updates[name] = u.t() if transposed else u

        # clip_by_block_rms and scale_by_param_block_rms, over esm_tpu's leaves
        leaves: Dict[tuple, list] = {}
        for name in params:
            leaves.setdefault(plan[name][0], []).append(name)
        lr = self.learning_rate(state.count)
        decay = decay_mask(model) if self.weight_decay_rate else {}
        for path, (u_sq, p_sq, n) in self._block_sums(shard, leaves, updates, params).items():
            u_rms = torch.sqrt(u_sq / n)
            clip = torch.clamp(u_rms / self.clipping_threshold, min=1.0)
            p_rms = torch.sqrt(p_sq / n)
            p_scale = torch.where(p_rms <= self.min_scale, self.min_scale, p_rms)
            for k in leaves[path]:
                u = (lr * (updates[k] / clip)) * p_scale
                if decay.get(k, False):
                    u = u + self.weight_decay_rate * params[k]
                params[k].add_(-u)
        state.count += 1


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    warmup_steps: int = 2000,
    total_steps: int = 100_000,
    grad_clip_norm: Optional[float] = None,
    mu_dtype: Optional[torch.dtype] = None,
    factored: bool = False,
):
    """AdamW (b1 0.9, b2 0.98, eps 1e-8) with the warmup-cosine schedule
    (learning rate 0 at step 0). ``grad_clip_norm`` prepends global-norm
    clipping; ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the first moments
    in that type. ``factored=True`` switches to :class:`Adafactor` (row and
    column second-moment statistics: optimizer state ~params/1000), weight
    decay under the same mask."""
    schedule = warmup_cosine_schedule(learning_rate, warmup_steps, total_steps)
    if factored:
        return Adafactor(schedule, weight_decay_rate=weight_decay or None,
                         grad_clip_norm=grad_clip_norm)
    return AdamW(schedule, weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
                 mu_dtype=mu_dtype)


def fold_optimizer(learning_rate: float = 1e-4) -> AdamW:
    """The fold fine-tuning optimizer of esm_tpu's example,
    optax.chain(clip_by_global_norm(1.0), adamw(learning_rate)): a constant
    rate, b2 0.999, weight decay 1e-4 on every parameter."""
    return AdamW(lambda count: learning_rate, weight_decay=1e-4, grad_clip_norm=1.0,
                 b2=0.999, decay_all=True)


def init_state(model: nn.Module, tx) -> TrainState:
    """A fresh state over ``model``'s parameters (a LoRA module's adapters for
    the LoRA steps)."""
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


def _corrupt_batch(cfg, generator: torch.Generator, tokens: torch.Tensor):
    """``cfg``: any language model's config (ESM-2, ESM-1, MSA Transformer)."""
    special = (
        (tokens == cfg.padding_idx)
        | (tokens == cfg.cls_idx)
        | (tokens == cfg.eos_idx)
    )
    return mask_tokens(generator, tokens, mask_idx=cfg.mask_idx, padding_idx=cfg.padding_idx,
                       special_mask=special)


def _mlm_terms(model, cfg, corrupted, targets, target_mask, apply_fn=None):
    """Per-position masked-CE terms: (nll.w, correct.w, w), each shaped like
    the tokens. ``apply_fn`` is the family's apply (esm2.apply by default;
    esm1.apply, msa_transformer.apply)."""
    logits = (apply_fn or esm2.apply)(model, cfg, corrupted)["logits"]
    return _terms_of_logits(logits, targets, target_mask)


def _terms_of_logits(logits, targets, target_mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = target_mask.to(nll.dtype)
    correct = (logits.argmax(-1) == targets) * w
    return nll * w, correct, w


def mlm_loss_sums(model, cfg, corrupted, targets, target_mask,
                  apply_fn=None) -> Tuple[torch.Tensor, dict]:
    """Unnormalised masked CE: (sum of the NLL over the masked positions,
    {"correct", "count"}). Linear in the batch, so sums from microbatches add
    exactly: the basis of gradient accumulation."""
    nll_w, correct, w = _mlm_terms(model, cfg, corrupted, targets, target_mask, apply_fn)
    return nll_w.sum(), {"correct": correct.sum(), "count": w.sum()}


def mlm_loss(model, cfg, corrupted, targets, target_mask,
             apply_fn=None) -> Tuple[torch.Tensor, dict]:
    nll_sum, aux = mlm_loss_sums(model, cfg, corrupted, targets, target_mask, apply_fn)
    denom = aux["count"].clamp_min(1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "acc": aux["correct"] / denom, "num_masked": aux["count"]}


def _step(state: TrainState, tx, loss_fn, context=None) -> Tuple[TrainState, dict]:
    """Loss and gradients of ``loss_fn()`` -> (loss, metrics), both under
    ``context`` (the backward, and remat's recompute, need what the forward
    had), then one update of ``state.model``'s parameters. Metrics stay on
    the device."""
    def loss_and_grads():
        with context or contextlib.nullcontext():
            loss, metrics = loss_fn()
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    return _grads_step(state, tx, loss_and_grads)


def _grads_step(state: TrainState, tx, loss_and_grads) -> Tuple[TrainState, dict]:
    """``loss_and_grads()`` (which leaves each parameter's ``.grad`` and
    returns the metrics) on zeroed gradients, then one update of
    ``state.model``'s parameters."""
    model = state.model
    model.zero_grad(set_to_none=True)
    metrics = loss_and_grads()
    tx.update(model, state.opt_state)
    model.zero_grad(set_to_none=True)
    return TrainState(model, state.opt_state, state.step + 1), metrics


@contextlib.contextmanager
def frozen_and_patched(base: nn.Module, adapters: _lora.LoRA, scale: float):
    """``base`` with ``adapters`` attached and no parameter requiring a
    gradient (esm_tpu's stop_gradient on the base), as a LoRA step runs its
    loss and backward; restored on exit."""
    flags = [(p, p.requires_grad) for p in base.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        with _lora.patch(base, adapters, scale=scale):
            yield base
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _mlm_piece(model, cfg, corrupted, targets, target_mask, apply_fn):
    nll_sum, aux = mlm_loss_sums(model, cfg, corrupted, targets, target_mask, apply_fn)
    return nll_sum, aux["correct"], aux["count"]


def _mlm_pieces(model, cfg, batch, accum_steps: int, apply_fn=None):
    """One loss piece (see :func:`_mlm_backward`) per microbatch of ``batch``
    = (corrupted, targets, target_mask), split into ``accum_steps``."""
    return [functools.partial(_mlm_piece, model, cfg, *mb, apply_fn)
            for mb in zip(*(x.chunk(accum_steps) for x in batch))]


def _mlm_backward(model: nn.Module, pieces, sum_over=None) -> torch.Tensor:
    """The backward of the masked-LM loss of ``pieces``: callables, one per
    microbatch, each returning (its NLL sum, with the graph; its correct
    count; its masked count). The three sums over every piece, and with
    ``sum_over`` (an in-place sum, e.g. over the ranks that hold other rows)
    over the group, give the one denominator: a single piece's NLL sum is
    divided by it before its backward; several pieces' NLL-sum gradients
    add up and are divided once. Each parameter's ``.grad`` is left holding
    this rank's part. Returns the sums (nll, correct, count)."""
    if len(pieces) == 1:
        nll_sum, correct, count = pieces[0]()
        sums = torch.stack([nll_sum.detach(), correct, count])
        if sum_over is not None:
            sum_over(sums)
        (nll_sum / sums[2].clamp_min(1.0)).backward()
        return sums
    sums = 0.0
    for piece in pieces:
        nll_sum, correct, count = piece()
        nll_sum.backward()
        sums = sums + torch.stack([nll_sum.detach(), correct, count])
    if sum_over is not None:
        sum_over(sums)
    denom = sums[2].clamp_min(1.0)
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(denom)
    return sums


def _metrics(sums: torch.Tensor) -> dict:
    """The step's metrics from :func:`_mlm_backward`'s sums."""
    denom = sums[2].clamp_min(1.0)
    return {"loss": sums[0] / denom, "acc": sums[1] / denom, "num_masked": sums[2]}


def train_step_corrupted(
    state: TrainState,
    cfg,
    tx,
    corrupted: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    accum_steps: int = 1,
    apply_fn=None,
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
    if sharding_of(model) is not None:
        return _grads_step(state, tx, lambda: sharded_loss_and_grads(
            model, cfg, corrupted, targets, target_mask, accum_steps=accum_steps,
            apply_fn=apply_fn))
    batch = (corrupted, targets, target_mask)
    return _grads_step(state, tx, lambda: _metrics(_mlm_backward(
        model, _mlm_pieces(model, cfg, batch, accum_steps, apply_fn))))


def train_step(state: TrainState, cfg: esm2.ESM2Config, tx,
               generator: torch.Generator, tokens: torch.Tensor) -> Tuple[TrainState, dict]:
    """One MLM step on a (B, T) token batch: corrupt with ``generator``, then
    :func:`train_step_corrupted`."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_corrupted(state, cfg, tx, corrupted, tokens, target_mask)


def train_step_accum(state: TrainState, cfg: esm2.ESM2Config, tx,
                     generator: torch.Generator, tokens: torch.Tensor, *,
                     accum_steps: int) -> Tuple[TrainState, dict]:
    """:func:`train_step` over ``accum_steps`` microbatches: peak activation
    memory is that of B / accum_steps sequences, and the result is the same
    function of the batch."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_corrupted(state, cfg, tx, corrupted, tokens, target_mask,
                                accum_steps=accum_steps)


def sharded_loss_and_grads(model: nn.Module, cfg, corrupted: torch.Tensor,
                           targets: torch.Tensor, target_mask: torch.Tensor, *,
                           accum_steps: int = 1, apply_fn=None,
                           adapters: Optional[_lora.LoRA] = None) -> dict:
    """The masked-LM loss of a full (B, T) batch that every rank of a sharded
    model's mesh holds: each rank keeps its rows (``batch_rows``; the tp
    ranks the same ones), the NLL sums and counts are summed over (data,
    fsdp) before the division, and each parameter's ``.grad`` is left
    holding its shard of the whole batch's gradient (``Sharding.sync_grads``).
    With ``accum_steps`` > 1 a rank's rows run as that many microbatches
    whose NLL-sum gradients add up and are divided once. With ``adapters``
    (a LoRA module attached to the frozen ``model``) the adapters take the
    gradients, the whole batch's on every rank
    (``Sharding.sync_adapter_grads``). Returns the metrics."""
    shard = sharding_of(model)
    rows = [batch_rows(x, shard) for x in (corrupted, targets, target_mask)]
    sums = _mlm_backward(model if adapters is None else adapters,
                         _mlm_pieces(model, cfg, rows, accum_steps, apply_fn),
                         functools.partial(dp_sum, sharding=shard))
    if adapters is None:
        shard.sync_grads(model)
    else:
        shard.sync_adapter_grads(adapters)
    return _metrics(sums)


def pp_loss_and_grads(model: nn.Module, cfg: esm2.ESM2Config, corrupted: torch.Tensor,
                      targets: torch.Tensor, target_mask: torch.Tensor, *,
                      num_microbatches: int, adapters: Optional[_lora.LoRA] = None) -> dict:
    """:func:`sharded_loss_and_grads` through the GPipe pipeline of a model
    sharded over a pp mesh: the embedding on every stage (stage 0 feeds
    it), the layer stack as ``num_microbatches`` microbatches through the
    stages, the final LN, head and loss on the last stage, then the reverse
    schedule (parallel/pipeline.py). The metrics are the last stage's,
    broadcast to every stage. With ``adapters`` (the stage's LoRA module,
    attached to the frozen ``model``) the adapters take the gradients, each
    from its stage's backward (``Sharding.sync_adapter_grads``)."""
    from .parallel.pipeline import Stage, pipeline_backward, pipeline_forward, stage_function

    shard = sharding_of(model)
    st = Stage(shard.mesh)
    corrupted, targets, target_mask = (batch_rows(x, shard)
                                       for x in (corrupted, targets, target_mask))
    x = esm2.embed_tokens(model, cfg, corrupted)
    static = dataclasses.replace(cfg.layer_static(), shard=shard)
    run = stage_function([model.layers[i] for i in shard.layer_ids], static)
    kw = dict(mesh=shard.mesh, num_microbatches=num_microbatches)
    inputs, outputs = pipeline_forward(run, x, corrupted == cfg.padding_idx, keep_graph=True,
                                       **kw)
    sums = torch.zeros(3, device=x.device)
    grads = None
    if st.is_last:
        hs = [o.detach().requires_grad_() for o in outputs]

        def head_piece():
            h = layer_norm(model.emb_layer_norm_after, torch.cat(hs))
            logits = roberta_lm_head(model.lm_head, h.float(), model.embed_tokens.weight, shard)
            nll_w, correct, w = _terms_of_logits(logits, targets, target_mask)
            return nll_w.sum(), correct.sum(), w.sum()

        sums = _mlm_backward(model if adapters is None else adapters, [head_piece],
                             functools.partial(dp_sum, sharding=shard))
        grads = [hh.grad for hh in hs]
    in_grads = pipeline_backward(inputs, outputs, grads, **kw)
    if st.index == 0 and x.requires_grad:  # a frozen base's embedding takes none
        x.backward(torch.cat(in_grads))
    if st.group is not None:
        dist.broadcast(sums, src=st.last, group=st.group)
    if adapters is None:
        shard.sync_grads(model)
    else:
        shard.sync_adapter_grads(adapters)
    return _metrics(sums)


def train_step_pp_corrupted(state: TrainState, cfg: esm2.ESM2Config, tx, corrupted: torch.Tensor,
                            targets: torch.Tensor, target_mask: torch.Tensor, *,
                            num_microbatches: int) -> Tuple[TrainState, dict]:
    """:func:`train_step_pp` on a given full-batch corruption."""
    return _grads_step(state, tx, lambda: pp_loss_and_grads(
        state.model, cfg, corrupted, targets, target_mask, num_microbatches=num_microbatches))


def train_step_pp(state: TrainState, cfg: esm2.ESM2Config, tx, generator: torch.Generator,
                  tokens: torch.Tensor, *, num_microbatches: int) -> Tuple[TrainState, dict]:
    """Pipeline-parallel MLM step (esm_tpu/training.py:546): the objective of
    :func:`train_step`, with the layer stack run as a GPipe pipeline over the
    model's ``pp`` mesh axis (tp and fsdp inside each stage). Every rank
    passes the same full batch and a generator in the same state."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_pp_corrupted(state, cfg, tx, corrupted, tokens, target_mask,
                                   num_microbatches=num_microbatches)


def seq_loss_and_grads(model: nn.Module, cfg: esm2.ESM2Config, corrupted: torch.Tensor,
                       targets: torch.Tensor, target_mask: torch.Tensor, *, mesh,
                       seq_axis: str = "tp") -> dict:
    """The masked-LM loss of a full (B, T) batch that every rank of ``mesh``
    holds, run sequence-parallel: each rank keeps its shard (its rows over
    the mesh's other dimensions, its T/N columns over ``seq_axis``) and runs
    :func:`esm2.apply_seq_sharded`'s ring. The NLL sum and the counts are
    summed over all ranks before the division, and each parameter's
    ``.grad`` is left holding the gradient of the whole batch's loss, summed
    over all ranks (every rank's local loss reaches the other ranks' keys
    and values through the backward ring). Returns the metrics."""
    rows = [local_shard(x, mesh, seq_axis=seq_axis) for x in (corrupted, targets, target_mask)]
    ring = functools.partial(esm2.apply, ring=(mesh, seq_axis))
    sums = _mlm_backward(model, _mlm_pieces(model, cfg, rows, 1, ring), dist.all_reduce)
    works = [dist.all_reduce(p.grad, async_op=True)
             for p in model.parameters() if p.grad is not None]
    for work in works:
        work.wait()
    return _metrics(sums)


def train_step_seq_corrupted(state: TrainState, cfg: esm2.ESM2Config, tx,
                             corrupted: torch.Tensor, targets: torch.Tensor,
                             target_mask: torch.Tensor, *, mesh,
                             seq_axis: str = "tp") -> Tuple[TrainState, dict]:
    """:func:`train_step_seq` on a given full-batch corruption (the same on
    every rank): :func:`seq_loss_and_grads`, then one optimizer update of the
    replicated parameters, which every rank makes alike (the global-norm
    clip sees the whole gradient)."""
    return _grads_step(state, tx, lambda: seq_loss_and_grads(
        state.model, cfg, corrupted, targets, target_mask, mesh=mesh, seq_axis=seq_axis))


def train_step_seq(state: TrainState, cfg: esm2.ESM2Config, tx, generator: torch.Generator,
                   tokens: torch.Tensor, *, mesh, seq_axis: str = "tp") -> Tuple[TrainState, dict]:
    """Sequence-parallel MLM step (esm_tpu/training.py:522): the same
    objective and gradients as :func:`train_step` on the full batch, with
    the T axis split over ``mesh``'s ``seq_axis`` and ring attention, so
    activations are O(T/N) per rank. Every rank passes the same tokens and a
    ``generator`` in the same state, so all draw the same corruption of the
    full batch, then keep their shards. The parameters stay replicated on
    every rank (sequence parallelism does not compose with
    ``parallel.sharding``), so the mesh's ``fsdp`` dimension splits the
    batch as ``data`` does here."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_seq_corrupted(state, cfg, tx, corrupted, tokens, target_mask, mesh=mesh,
                                    seq_axis=seq_axis)


def train_step_msa(state: TrainState, cfg, tx, generator: torch.Generator,
                   tokens: torch.Tensor) -> Tuple[TrainState, dict]:
    """One MLM step of the MSA Transformer on (B, R, C) MSA tokens: the same
    objective (masking uniform over rows and columns; the per-row cls tokens
    and padding never selected). ``cfg`` is an MSATransformerConfig."""
    from .models import msa_transformer

    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_corrupted(state, cfg, tx, corrupted, tokens, target_mask,
                                apply_fn=msa_transformer.apply)


def train_step_lora_corrupted(
    state: TrainState,
    base: nn.Module,
    cfg,
    tx,
    corrupted: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    scale: float = 1.0,
    apply_fn=None,
    num_microbatches: Optional[int] = None,
) -> Tuple[TrainState, dict]:
    """:func:`train_step_lora` on a given corruption."""
    shard = sharding_of(base)
    if shard is not None and shard.stages > 1 and num_microbatches is None:
        raise ValueError("a LoRA step over a pipeline-sharded base takes num_microbatches")
    if num_microbatches is not None:
        if shard is None or apply_fn is not None:
            raise ValueError("num_microbatches pipelines ESM-2 over a pp mesh "
                             "(parallel.pipeline.make_pp_mesh)")

        def loss_and_grads():
            with frozen_and_patched(base, state.model, scale):
                return pp_loss_and_grads(base, cfg, corrupted, targets, target_mask,
                                         num_microbatches=num_microbatches, adapters=state.model)

        return _grads_step(state, tx, loss_and_grads)
    if shard is not None:
        def loss_and_grads():
            with frozen_and_patched(base, state.model, scale):
                return sharded_loss_and_grads(base, cfg, corrupted, targets, target_mask,
                                              apply_fn=apply_fn, adapters=state.model)

        return _grads_step(state, tx, loss_and_grads)
    return _step(state, tx,
                 lambda: mlm_loss(base, cfg, corrupted, targets, target_mask, apply_fn),
                 frozen_and_patched(base, state.model, scale))


def train_step_lora(
    state: TrainState,
    base: nn.Module,
    cfg,
    tx,
    generator: torch.Generator,
    tokens: torch.Tensor,
    *,
    scale: float = 1.0,
    apply_fn=None,
    num_microbatches: Optional[int] = None,
) -> Tuple[TrainState, dict]:
    """One parameter-efficient MLM step: ``state.model`` is the LoRA module
    (esm_tpu_torch/lora.py), ``base`` the frozen base (fp32, bf16 or
    weight-only int8). Only the adapters get gradients, and the optimizer
    state covers only them; ``scale`` is the LoRA alpha / rank. ``apply_fn``
    swaps the family, e.g. ``msa_transformer.apply`` with an
    MSATransformerConfig and (B, R, C) tokens. Over a ``base`` sharded by
    ``parallel.sharding.shard_params`` every rank passes the full batch and
    keeps its rows, as :func:`train_step` does; the adapters stay whole on
    every rank and get the whole batch's gradient, so every rank makes the
    same update. Over an ESM-2 base sharded on a pp mesh
    (``pipeline.make_pp_mesh``), ``num_microbatches`` runs the step through
    :func:`train_step_pp`'s GPipe schedule (esm_tpu's ``train_step_lora``
    with ``apply_fn=partial(esm2.apply_pipelined, ...)``); ``state.model``
    is then the stage's adapters (``lora.init_lora`` over the sharded base,
    or ``lora.on_stage``)."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    return train_step_lora_corrupted(state, base, cfg, tx, corrupted, tokens, target_mask,
                                     scale=scale, apply_fn=apply_fn,
                                     num_microbatches=num_microbatches)


def if_loss_sums(model, cfg, coords, padding_mask, confidence, tokens) -> Tuple[torch.Tensor, dict]:
    """Teacher-forced sequence cross-entropy sums of ESM-IF1 (the batched form
    of the reference's per-sequence scoring objective,
    esm/inverse_folding/util.py:106-121) on CoordBatchConverter batches:
    (sum of the NLL over the non-pad targets, {"correct", "count"}), so
    microbatch sums add exactly."""
    prev, target = tokens[:, :-1], tokens[:, 1:]
    logits = model(coords, padding_mask, confidence, prev)  # (B, V, T)
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -torch.gather(logp, 1, target[:, None, :])[:, 0]
    w = (target != cfg.padding_idx).to(nll.dtype)
    correct = (logits.argmax(1) == target) * w
    return (nll * w).sum(), {"correct": correct.sum(), "count": w.sum()}


def _if_loss(model, cfg, batch) -> Tuple[torch.Tensor, dict]:
    nll, aux = if_loss_sums(model, cfg, *batch)
    denom = aux["count"].clamp_min(1.0)
    loss = nll / denom
    return loss, {"loss": loss, "acc": aux["correct"] / denom, "num_targets": aux["count"]}


def train_step_if(state: TrainState, cfg, tx, coords, padding_mask, confidence,
                  tokens) -> Tuple[TrainState, dict]:
    """One inverse-folding fine-tuning step, full parameters: teacher-forced
    CE on (backbone, sequence) pairs from CoordBatchConverter. ``cfg`` is the
    GVPTransformerConfig."""
    batch = (coords, padding_mask, confidence, tokens)
    return _step(state, tx, lambda: _if_loss(state.model, cfg, batch))


def train_step_if_lora(state: TrainState, base: nn.Module, cfg, tx, coords, padding_mask,
                       confidence, tokens, *, scale: float = 1.0) -> Tuple[TrainState, dict]:
    """:func:`train_step_if` with ``state.model`` a LoRA module over the
    frozen ESM-IF1 ``base`` (the default targets cover the encoder's and
    decoder's attention and MLP linears)."""
    batch = (coords, padding_mask, confidence, tokens)
    return _step(state, tx, lambda: _if_loss(base, cfg, batch),
                 frozen_and_patched(base, state.model, scale))


def split_fold_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """Freeze ESMFold's LM in place (``requires_grad`` off) and return the
    trainable parameters by name: the LM and the ``af2_to_esm`` lookup table
    are frozen (the reference trains the trunk and heads against a frozen
    ESM-2, esm/esmfold/v1/esmfold.py:198); ``esm_s_combine`` trains."""
    model.esm.requires_grad_(False)
    return trainable(model)


def _fold_loss(model, cfg, batch, weights, num_recycles) -> Tuple[torch.Tensor, dict]:
    from .models.esmfold import esmfold as ef
    from .models.esmfold import losses as fl

    aa, mask, coords, coord_mask, masking_pattern = batch
    structure = ef.apply(model, cfg, aa, mask=mask, masking_pattern=masking_pattern,
                         num_recycles=num_recycles)
    return fl.fold_loss(structure, cfg, aa, mask, coords, coord_mask,
                        weights=weights or fl.FoldLossWeights(), masking_pattern=masking_pattern)


def _check_lm_frozen(model: nn.Module) -> None:
    if any(p.requires_grad for p in model.esm.parameters()):
        raise ValueError("ESMFold's LM requires grad: call split_fold_params(model) before "
                         "init_state, so that the optimizer leaves it out")


def train_step_fold(
    state: TrainState,
    cfg,
    tx,
    aa: torch.Tensor,
    mask: torch.Tensor,
    coords: torch.Tensor,
    coord_mask: torch.Tensor,
    *,
    masking_pattern: Optional[torch.Tensor] = None,
    weights=None,
    num_recycles: int = 0,
) -> Tuple[TrainState, dict]:
    """One ESMFold structure fine-tuning step: backbone FAPE, distogram CE and
    pLDDT-head CE (models/esmfold/losses.py) on (sequence, backbone) pairs.
    ``state.model`` is the ESMFold whose LM :func:`split_fold_params` froze;
    ``cfg`` the ESMFoldConfig; ``aa``/``mask`` (B, L) AF2-indexed residues;
    ``coords`` (B, L, 3, 3) ground-truth N/CA/C in Å; ``coord_mask`` (B, L)
    marks resolved residues. ``masking_pattern`` (with ``weights.lm`` > 0)
    adds the masked-LM auxiliary on the trunk's lm_head. The triangle
    kernels K6-K8 have no backward: run the trunk's plain paths
    (``use_flash_tri=False``), as esm_tpu's fold training does."""
    _check_lm_frozen(state.model)
    batch = (aa, mask, coords, coord_mask, masking_pattern)
    return _step(state, tx, lambda: _fold_loss(state.model, cfg, batch, weights, num_recycles))


def train_step_fold_lora(
    state: TrainState,
    base: nn.Module,
    cfg,
    tx,
    aa: torch.Tensor,
    mask: torch.Tensor,
    coords: torch.Tensor,
    coord_mask: torch.Tensor,
    *,
    masking_pattern: Optional[torch.Tensor] = None,
    weights=None,
    num_recycles: int = 0,
    scale: float = 1.0,
) -> Tuple[TrainState, dict]:
    """:func:`train_step_fold` with ``state.model`` a LoRA module over the
    frozen ESMFold ``base`` (``lora.init_lora(..., targets=lora.fold_targets)``
    adapts every linear of the trunk and the heads); the base is left as it
    is."""
    batch = (aa, mask, coords, coord_mask, masking_pattern)
    return _step(state, tx, lambda: _fold_loss(base, cfg, batch, weights, num_recycles),
                 frozen_and_patched(base, state.model, scale))


@torch.no_grad()
def eval_step(model: nn.Module, cfg, generator: torch.Generator,
              tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Masked-LM evaluation on one batch: the training corruption
    (deterministic given ``generator``), returning per-sequence sums
    {"nll_sum", "correct", "count"}, each (B,), so callers aggregate an exact
    masked perplexity, exp(sum nll / sum count), over any number of batches.
    On a sharded model every rank passes the full batch and gets its rows'
    sums."""
    corrupted, target_mask = _corrupt_batch(cfg, generator, tokens)
    shard = sharding_of(model)
    if shard is not None:  # this rank's rows of the full batch
        corrupted, tokens, target_mask = (batch_rows(x, shard)
                                          for x in (corrupted, tokens, target_mask))
    nll_w, correct, w = _mlm_terms(model, cfg, corrupted, tokens, target_mask)
    return {"nll_sum": nll_w.sum(-1), "correct": correct.sum(-1), "count": w.sum(-1)}
