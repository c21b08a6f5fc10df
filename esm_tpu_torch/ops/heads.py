"""Output heads: masked-LM head and contact prediction head.

Port of esm_tpu/ops/heads.py (reference semantics: esm/modules.py:298-357).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import tensor_parallel as tpar
from .common import (
    gelu_erf,
    layer_norm,
    linear,
    materialize_weight,
    new_layer_norm,
    new_linear,
)


class RobertaLMHead(nn.Module):
    """dense -> GELU -> LN -> projection tied to the token embedding, + bias
    (reference RobertaLMHead, esm/modules.py:298-314). ``weight`` is the
    embedding's Parameter itself, so the state dict carries both keys as the
    reference's does."""

    def __init__(self, embed_dim: int, output_dim: int, weight: nn.Parameter, device=None):
        super().__init__()
        self.dense = new_linear(embed_dim, embed_dim, device=device)
        self.layer_norm = new_layer_norm(embed_dim, device=device)
        self.weight = weight
        self.bias = nn.Parameter(torch.zeros(output_dim, device=device))


class ContactPredictionHead(nn.Module):
    """Logistic regression over all layers' and heads' attention maps
    (reference ContactPredictionHead, esm/modules.py:317-357)."""

    def __init__(self, in_features: int, device=None):
        super().__init__()
        self.regression = new_linear(in_features, 1, device=device)


def roberta_lm_head(
    head: RobertaLMHead, features: torch.Tensor, embed_weight: torch.Tensor, shard=None,
) -> torch.Tensor:
    """features (B, T, D) -> logits (B, T, V), in features' dtype.

    ``shard``: the model's parallel.sharding.Sharding. The dense layer's
    weight is then gathered (over fsdp, and over tp for a product every tp
    rank runs alike), and the tied projection contracts this tp rank's
    features with its columns of the embedding: the partial logits are
    all-reduced over tp."""
    dense = head.dense
    tp = None
    if shard is not None:
        dense = tpar.gather_linear(head.dense, 1, shard.fsdp, shard.tp, 0, features.dtype)
        tp = shard.tp
    x = gelu_erf(linear(dense, features))
    x = layer_norm(head.layer_norm, x)
    if tp is not None:
        x = tpar.own_block(tpar.copy_to_tp(x, tp), -1, tp)
        return (tpar.reduce_from_tp(torch.matmul(x, embed_weight.to(x.dtype).t()), tp)
                + head.bias.to(x.dtype))
    return torch.matmul(x, embed_weight.to(x.dtype).t()) + head.bias.to(x.dtype)


def weighted_apc_symmetrize(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w_k . apc(symmetrize(a_k)) for an fp32 (B, K, T, T) map stack,
    restructured by linearity: contract K first, then apply apc's rank-1
    correction from per-map row and column sums (esm_tpu/ops/heads.py:30-45).
    The streaming contact path (models/esm2.py) accumulates one call per
    layer."""
    raw = torch.einsum("bkij,k->bij", a, w)
    row = a.sum(-1)                                     # (B, K, T)
    col = a.sum(-2)
    r = row + col                                       # rowsum of sym
    s = 2.0 * row.sum(-1)                               # total of sym
    w_over_s = torch.where(s == 0.0, torch.zeros_like(s), w[None, :] / s)  # (B, K)
    corr = torch.einsum("bk,bki,bkj->bij", w_over_s, r, r)
    return raw + raw.transpose(-1, -2) - corr


def contact_head(
    head: ContactPredictionHead,
    tokens: torch.Tensor,
    attentions: torch.Tensor,
    *,
    prepend_bos: bool,
    append_eos: bool,
    eos_idx: Optional[int] = None,
) -> torch.Tensor:
    """tokens (B, T); attentions (B, L, H, T, T) stacked per-layer per-head
    maps. Returns (B, T', T') contact probabilities with bos/eos stripped."""
    if append_eos:
        if eos_idx is None:
            raise ValueError("Using an alphabet with eos token, but no eos token was passed in.")
        eos_mask = (tokens != eos_idx).to(attentions.dtype)
        eos_mask = eos_mask[:, None, :] * eos_mask[:, :, None]
        attentions = attentions * eos_mask[:, None, None, :, :]
        attentions = attentions[..., :-1, :-1]
    if prepend_bos:
        attentions = attentions[..., 1:, 1:]

    b, layers, heads, seqlen, _ = attentions.shape
    a = attentions.reshape(b, layers * heads, seqlen, seqlen)
    w = materialize_weight(head.regression, torch.float32)[0]  # (L*H,)
    logits = weighted_apc_symmetrize(a.float(), w)
    bias = head.regression.bias
    if bias is not None:
        logits = logits + bias.float()[0]
    return torch.sigmoid(logits)
