"""Shared pre-LN transformer stack for the ESM language models.

Port of esm_tpu/models/lm_common.py. The JAX package stacks per-layer
parameters and drives them with ``lax.scan``; here the layers are an
``nn.ModuleList`` and the stack is a Python loop, as in the reference
(esm/model/esm2.py:111-121). Layer semantics follow the reference
TransformerLayer (esm/modules.py:84-142): pre-LN attention + residual, pre-LN
GELU MLP + residual; optional per-head attention maps.

Rematerialization (esm_tpu/models/lm_common.py:33-67, :139-147): with
``LayerStatic.remat`` each layer runs under non-reentrant
``torch.utils.checkpoint``, so the backward recomputes its activations
instead of keeping them for the whole stack. ``remat_policy="dots"`` keeps
the matrix-product outputs and recomputes the rest, as JAX's
``dots_saveable`` does (the flash kernel's output is not a product, so it is
recomputed too); ``"full"`` keeps only each layer's input.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..ops.attention import SelfAttention, multihead_attention
from ..ops.common import (
    gelu_erf,
    init_layer_norm,
    init_linear,
    init_linear_torch_default,
    layer_norm,
    linear,
    new_layer_norm,
    new_linear,
)
from ..parallel.tensor_parallel import copy_to_tp, row_parallel_linear


@dataclass(frozen=True)
class LayerStatic:
    """Options of a transformer layer."""

    num_heads: int
    use_rotary: bool = True
    use_bias_kv: bool = False
    ln_eps: float = 1e-5            # ESM-1b/2 LayerNorm eps; ESM-1 uses 1e-12
    use_flash: bool = False
    # Recompute the layer body on the backward pass (training memory:
    # activations O(1) layers deep instead of O(num_layers)).
    remat: bool = False
    # With remat: "dots" keeps matrix-product outputs (the recompute is
    # elementwise work and attention); "full" saves nothing but the layer
    # input (least memory, about a third more operations).
    remat_policy: str = "dots"
    # Sequence parallelism: (DeviceMesh, axis name) splits the T axis over
    # that mesh dimension and runs attention as a ring
    # (parallel/ring_attention.py). Under remat the recompute runs the ring's
    # forward again, so every rank of the ring must issue it in step.
    ring: Optional[tuple] = None
    # Parameter sharding: the model's parallel.sharding.Sharding. Each layer
    # gathers its fsdp-sharded weights before it runs (again in the remat
    # recompute) and runs this tp rank's heads and MLP columns, with
    # Megatron's collectives (parallel/tensor_parallel.py).
    shard: Optional[object] = None


# The matrix products a "dots" layer keeps (dispatcher-level ops: nn.Linear
# and torch.matmul reach these).
_DOTS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
)


def checkpoint_context(name: str):
    """The ``context_fn`` of torch.utils.checkpoint for a remat_policy name:
    "dots" saves the matrix products (selective checkpointing), "full" saves
    nothing (the default context)."""
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, list(_DOTS))
    if name == "full":
        return None
    raise ValueError(f"unknown remat_policy {name!r} (use 'dots' or 'full')")


class TransformerLayer(nn.Module):
    """Parameters of one pre-LN block, named as the reference's
    TransformerLayer (self_attn, self_attn_layer_norm, fc1, fc2,
    final_layer_norm)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, *,
                 use_rotary: bool = True, use_bias_kv: bool = False, device=None):
        super().__init__()
        self.self_attn = SelfAttention(embed_dim, num_heads, use_rotary=use_rotary,
                                       use_bias_kv=use_bias_kv, device=device)
        self.self_attn_layer_norm = new_layer_norm(embed_dim, device=device)
        self.fc1 = new_linear(embed_dim, ffn_dim, device=device)
        self.fc2 = new_linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = new_layer_norm(embed_dim, device=device)

    def init_(self, generator: torch.Generator) -> "TransformerLayer":
        """The reference's init (esm/multihead_attention.py:139-157: xavier
        with gain 1/sqrt(2) for q/k/v, xavier for out_proj; torch default for
        the FFN); ESM-1's bias_k/bias_v are N(0, 2 / (D + 1)), as
        esm_tpu/models/lm_common.py:187-199 draws them (the reference's
        xavier-normal on a (1, 1, D) tensor)."""
        a = self.self_attn
        for proj in (a.q_proj, a.k_proj, a.v_proj):
            init_linear(proj, generator, gain=1 / math.sqrt(2))
        init_linear(a.out_proj, generator)
        if hasattr(a, "bias_k"):
            d = a.bias_k.shape[-1]
            with torch.no_grad():
                for p in (a.bias_k, a.bias_v):
                    p.normal_(generator=generator).mul_(math.sqrt(2.0 / (d + 1)))
        init_linear_torch_default(self.fc1, generator)
        init_linear_torch_default(self.fc2, generator)
        init_layer_norm(self.self_attn_layer_norm)
        init_layer_norm(self.final_layer_norm)
        return self


def embedding_lookup(weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``weight[tokens]`` with a backward that sums each row's gradients in a
    fixed order, so a training step, and a resumed run, repeats bit for bit:
    on the CPU ``F.embedding``'s backward does (indexing's adds atomically
    there), on CUDA indexing's, an ``index_put_(accumulate=True)`` that sorts
    the rows (``F.embedding``'s adds atomically there)."""
    if weight.device.type == "cpu":
        return torch.nn.functional.embedding(tokens, weight)
    return weight[tokens]


def transformer_layer_apply(
    layer: TransformerLayer,
    x: torch.Tensor,
    *,
    static: LayerStatic,
    key_padding_mask: Optional[torch.Tensor] = None,
    need_head_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-LN block on (B, T, D). Returns (x, probs (B, H, T, S) or None)."""
    tp_group, num_heads = None, static.num_heads
    if static.shard is not None:
        layer = static.shard.gather_layer(layer, x.dtype)
        tp_group = static.shard.tp
        num_heads //= static.shard.sizes["tp"]
    residual = x
    h = layer_norm(layer.self_attn_layer_norm, x, eps=static.ln_eps)
    attn_out, probs = multihead_attention(
        layer.self_attn,
        h,
        num_heads=num_heads,
        key_padding_mask=key_padding_mask,
        use_rotary=static.use_rotary,
        use_bias_kv=static.use_bias_kv,
        need_weights=need_head_weights,
        use_flash=static.use_flash,
        ring=static.ring,
        tp_group=tp_group,
    )
    x = residual + attn_out

    residual = x
    h = layer_norm(layer.final_layer_norm, x, eps=static.ln_eps)
    h = linear(layer.fc1, copy_to_tp(h, tp_group))  # column-parallel
    h = row_parallel_linear(layer.fc2, gelu_erf(h), tp_group)
    return residual + h, probs


def transformer_stack_apply(
    layers: Sequence[TransformerLayer],
    x: torch.Tensor,
    *,
    static: LayerStatic,
    key_padding_mask: Optional[torch.Tensor] = None,
    collect_hiddens: bool = False,
    collect_layer_ids: Optional[Tuple[int, ...]] = None,
    need_head_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run the layers in order. Returns (x, hiddens, attentions):
      hiddens:    (L, B, T, D) every layer's output when collect_hiddens, or
                  (k, B, T, D) for the 1-based ``collect_layer_ids`` only
                  (the reference keeps only the requested repr_layers,
                  esm/model/esm2.py:117-118); None otherwise
      attentions: (L, B, H, T, S) per-head probabilities, or None
    """
    selective = collect_layer_ids is not None and not collect_hiddens
    wanted = set(collect_layer_ids or ()) if selective else set()
    hiddens: List[torch.Tensor] = []
    attns: List[torch.Tensor] = []
    layer_fn = functools.partial(
        transformer_layer_apply, static=static, key_padding_mask=key_padding_mask,
        need_head_weights=need_head_weights,
    )
    if static.remat:
        context = checkpoint_context(static.remat_policy)
        kw = {} if context is None else {"context_fn": context}
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False, **kw)
    for i, layer in enumerate(layers):
        x, probs = layer_fn(layer, x)
        if collect_hiddens or (i + 1) in wanted:
            hiddens.append(x)
        if need_head_weights:
            attns.append(probs)
    stacked = None
    if collect_hiddens or selective:
        # selective ids come sorted and unique (normalize_repr_layers), so
        # the layer order is the requested order
        stacked = torch.stack(hiddens) if hiddens else x.new_zeros((0,) + x.shape)
    return x, stacked, (torch.stack(attns) if need_head_weights else None)


def normalize_repr_layers(repr_layers, num_layers: int):
    """Resolve negative layer indices against num_layers and dedupe/sort (the
    reference accepts e.g. ``repr_layers=[-1]``, scripts/extract.py:87-90).
    Returns a tuple, or None."""
    if repr_layers is None:
        return None
    return tuple(sorted({(i if i >= 0 else num_layers + 1 + i) for i in repr_layers}))
