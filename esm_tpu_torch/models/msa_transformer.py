"""MSA Transformer.

Port of esm_tpu/models/msa_transformer.py (reference semantics:
esm/model/msa_transformer.py): (B, R, C) token inputs, a learned per-row
positional embedding, an optional 1024-row MSA position embedding, axial
transformer layers (tied row attention, column attention and an FFN, each a
pre-LN residual block, esm/modules.py:145-221, :360-418), final LN, tied LM
head, contacts from the stacked row attentions. ``MSATransformer`` holds the
parameters under the reference's names. The axial attentions are plain
PyTorch: the JAX package has no Pallas kernel for them.

A model sharded by ``parallel.sharding.shard_params`` runs through
:func:`apply` as it is: each layer's weights gathered over fsdp, row and
column attention on this tp rank's heads, a column/row-parallel
feed-forward (Megatron's collectives, parallel/tensor_parallel.py);
``tokens`` are this rank's MSAs (``parallel.sharding.batch_rows`` splits
dim 0 of (B, R, C)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..data.alphabet import Alphabet
from ..ops.axial_attention import AxialAttention, column_self_attention, row_self_attention
from ..ops.common import (
    gelu_erf,
    init_embedding,
    init_layer_norm,
    init_linear_torch_default,
    layer_norm,
    linear,
    new_embedding,
    new_layer_norm,
    new_linear,
)
from ..ops.heads import ContactPredictionHead, RobertaLMHead, contact_head, roberta_lm_head
from ..ops.positional import learned_positional_embedding
from ..parallel.sharding import sharding_of
from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, row_parallel_linear
from .lm_common import embedding_lookup, normalize_repr_layers

MAX_MSA_ROWS = 1024  # rows of the MSA position embedding (reference msa_transformer.py:102-107)


@dataclass(frozen=True)
class MSATransformerConfig:
    num_layers: int = 12
    embed_dim: int = 768
    ffn_embed_dim: int = 3072
    attention_heads: int = 12
    max_positions: int = 1024
    embed_positions_msa: bool = True
    # Chunk the axial attentions when R*C exceeds this (reference
    # max_tokens_per_msa, esm/model/msa_transformer.py:229-238)
    max_tokens_per_msa: int = 2 ** 14
    # Alphabet-derived (msa_transformer alphabet)
    alphabet_size: int = 33
    padding_idx: int = 1
    mask_idx: int = 32
    cls_idx: int = 0
    eos_idx: int = 2
    prepend_bos: bool = True
    append_eos: bool = False
    # Execution option
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def from_alphabet(cls, alphabet: Alphabet, **kw) -> "MSATransformerConfig":
        return cls(
            alphabet_size=len(alphabet),
            padding_idx=alphabet.padding_idx,
            mask_idx=alphabet.mask_idx,
            cls_idx=alphabet.cls_idx,
            eos_idx=alphabet.eos_idx,
            prepend_bos=alphabet.prepend_bos,
            append_eos=alphabet.append_eos,
            **kw,
        )


# Released sizes, by registry name: 12 layers, 768 wide, 12 heads, FFN 3072,
# 1024 positions (the reference's model table, facebookresearch/esm
# README.md "Available models", and the released args as
# tests/test_fullsize_conversion.py builds them); MSA-1b adds the 1024-row
# MSA position embedding, MSA-1 has none. A loaded checkpoint's own args
# always win over this table.
_MSA = dict(num_layers=12, embed_dim=768, ffn_embed_dim=3072, attention_heads=12,
            max_positions=1024)
MSA_SIZES = {
    "esm_msa1_t12_100M_UR50S": dict(_MSA, embed_positions_msa=False),
    "esm_msa1b_t12_100M_UR50S": dict(_MSA, embed_positions_msa=True),
}


class _Residual(nn.Module):
    """The reference's NormalizedResidualBlock: its module under ``layer``,
    the pre-LN under ``layer_norm``."""

    def __init__(self, layer: nn.Module, embed_dim: int, device=None):
        super().__init__()
        self.layer = layer
        self.layer_norm = new_layer_norm(embed_dim, device=device)


class _FeedForward(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, device=None):
        super().__init__()
        self.fc1 = new_linear(embed_dim, ffn_dim, device=device)
        self.fc2 = new_linear(ffn_dim, embed_dim, device=device)


class AxialTransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, device=None):
        super().__init__()
        self.row_self_attention = _Residual(AxialAttention(embed_dim, device), embed_dim, device)
        self.column_self_attention = _Residual(AxialAttention(embed_dim, device), embed_dim,
                                               device)
        self.feed_forward_layer = _Residual(_FeedForward(embed_dim, ffn_dim, device), embed_dim,
                                            device)


class MSATransformer(nn.Module):
    """MSA Transformer parameters, named as the reference's module. Built
    without init: call :func:`init` or load a state dict."""

    def __init__(self, cfg: MSATransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed_tokens = new_embedding(cfg.alphabet_size, d, padding_idx=cfg.padding_idx,
                                          device=device)
        if cfg.embed_positions_msa:
            self.msa_position_embedding = nn.Parameter(
                torch.empty(1, MAX_MSA_ROWS, 1, d, device=device))
        self.layers = nn.ModuleList(AxialTransformerLayer(d, cfg.ffn_embed_dim, device)
                                    for _ in range(cfg.num_layers))
        self.contact_head = ContactPredictionHead(cfg.num_layers * cfg.attention_heads,
                                                  device=device)
        self.embed_positions = new_embedding(cfg.max_positions + cfg.padding_idx + 1, d,
                                             padding_idx=cfg.padding_idx, device=device)
        self.emb_layer_norm_before = new_layer_norm(d, device=device)
        self.emb_layer_norm_after = new_layer_norm(d, device=device)
        self.lm_head = RobertaLMHead(d, cfg.alphabet_size, self.embed_tokens.weight,
                                     device=device)

    def forward(self, tokens: torch.Tensor, **kw):
        return apply(self, self.cfg, tokens, **kw)


@torch.no_grad()
def init(cfg: MSATransformerConfig, generator: torch.Generator, device=None) -> MSATransformer:
    """Seeded random weights (esm_tpu/models/msa_transformer.py:70-134): N(0, 1)
    embeddings with zero padding rows, torch-default linear layers, unit
    LNs, 0.01 N(0, 1) MSA position embedding, zero LM-head bias and zero
    contact regression. ``generator`` must live on ``device``."""
    model = MSATransformer(cfg, device=device)
    init_embedding(model.embed_tokens, generator, padding_idx=cfg.padding_idx)
    for layer in model.layers:
        for block in (layer.row_self_attention, layer.column_self_attention):
            for proj in (block.layer.q_proj, block.layer.k_proj, block.layer.v_proj,
                         block.layer.out_proj):
                init_linear_torch_default(proj, generator)
        ffn = layer.feed_forward_layer
        init_linear_torch_default(ffn.layer.fc1, generator)
        init_linear_torch_default(ffn.layer.fc2, generator)
        for block in (layer.row_self_attention, layer.column_self_attention, ffn):
            init_layer_norm(block.layer_norm)
    init_embedding(model.embed_positions, generator, padding_idx=cfg.padding_idx)
    init_layer_norm(model.emb_layer_norm_before)
    init_layer_norm(model.emb_layer_norm_after)
    init_linear_torch_default(model.lm_head.dense, generator)
    init_layer_norm(model.lm_head.layer_norm)
    model.lm_head.bias.zero_()
    model.contact_head.regression.weight.zero_()
    model.contact_head.regression.bias.zero_()
    if cfg.embed_positions_msa:
        model.msa_position_embedding.normal_(generator=generator).mul_(0.01)
    return model


def axial_layer_apply(
    layer: AxialTransformerLayer,
    x: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: Optional[torch.Tensor],
    max_tokens_per_msa: int = 2 ** 14,
    shard=None,
    need_weights: bool = True,
):
    """One AxialTransformerLayer: three pre-LN residual blocks (reference
    esm/modules.py:196-221, :360-392). The axial attentions are chunked when
    R*C exceeds ``max_tokens_per_msa`` (esm_tpu/models/msa_transformer.py:147-149).
    ``shard``: the model's parallel.sharding.Sharding (the layer's weights
    gathered over fsdp, this tp rank's heads and feed-forward columns).
    Returns (x, row probs (B, H, C, C), column probs (B, H, C, R, R)); the
    probabilities are None without ``need_weights``."""
    b, r, c, d = x.shape
    tp = None
    if shard is not None:
        layer = shard.gather_layer(layer, x.dtype)
        tp = shard.tp
        num_heads //= shard.sizes["tp"]
    chunked = r * c > max_tokens_per_msa
    row = layer.row_self_attention
    h, row_probs = row_self_attention(
        row.layer, layer_norm(row.layer_norm, x), num_heads=num_heads,
        padding_mask=padding_mask,
        max_rows_per_chunk=max(1, max_tokens_per_msa // c) if chunked else None,
        tp_group=tp, need_weights=need_weights,
    )
    x = x + h
    col = layer.column_self_attention
    h, col_probs = column_self_attention(
        col.layer, layer_norm(col.layer_norm, x), num_heads=num_heads,
        padding_mask=padding_mask,
        max_cols_per_chunk=max(1, max_tokens_per_msa // r) if chunked else None,
        tp_group=tp, need_weights=need_weights,
    )
    x = x + h
    ffn = layer.feed_forward_layer
    h = layer_norm(ffn.layer_norm, x)
    h = linear(ffn.layer.fc1, copy_to_tp(h, tp))  # column-parallel
    h = row_parallel_linear(ffn.layer.fc2, gelu_erf(h), tp)
    return x + h, row_probs, col_probs


def apply(
    model: MSATransformer,
    cfg: MSATransformerConfig,
    tokens: torch.Tensor,
    *,
    need_head_weights: bool = False,
    return_contacts: bool = False,
    return_representations: bool = False,
    repr_layers=None,
):
    """Forward pass (esm_tpu/models/msa_transformer.py:189-314). tokens:
    (B, R, C) integer tensor on the model's device. Returns {"logits"
    (B, R, C, V) fp32, "representations" ((L+1, B, R, C, D), or a dict of the
    ``repr_layers``), "row_attentions" (B, L, H, C, C), "col_attentions"
    (B, L, H, C, R, R), "contacts" (B, C', C')}; contacts need the head
    weights, so ``return_contacts`` turns them on.

    A sharded model: ``tokens`` are this rank's MSAs (``batch_rows``; the tp
    ranks of a row group pass the same ones), every output is theirs, and
    the attention maps carry every head."""
    if return_contacts:
        need_head_weights = True
    b, r, c = tokens.shape
    padding_mask = tokens == cfg.padding_idx  # (B, R, C)
    shard = sharding_of(model)

    x = embedding_lookup(model.embed_tokens.weight, tokens)
    if shard is not None:  # each tp rank looked up its columns of the features
        x = gather_from_tp(x, -1, shard.tp)
    x = x + learned_positional_embedding(
        model.embed_positions, tokens.reshape(b * r, c), cfg.padding_idx, cfg.max_positions
    ).reshape(x.shape)
    if cfg.embed_positions_msa:
        if r > MAX_MSA_ROWS:
            raise ValueError(
                "Using model with MSA position embedding trained on maximum MSA "
                f"depth of {MAX_MSA_ROWS}, but received {r} alignments."
            )
        x = x + model.msa_position_embedding[:, :r]
    x = layer_norm(model.emb_layer_norm_before, x)
    x = x * (1 - padding_mask[..., None].to(x.dtype))
    x = x.to(cfg.compute_dtype)
    h0 = x

    repr_layers = normalize_repr_layers(repr_layers, cfg.num_layers)
    mid_layers = (
        set(i for i in repr_layers if 1 <= i <= cfg.num_layers - 1)
        if (repr_layers is not None and not return_representations)
        else set()
    )
    hiddens, selected, rows, cols = [], {}, [], []
    for i, layer in enumerate(model.layers):
        x, row_probs, col_probs = axial_layer_apply(
            layer, x, num_heads=cfg.attention_heads, padding_mask=padding_mask,
            max_tokens_per_msa=cfg.max_tokens_per_msa, shard=shard,
            need_weights=need_head_weights,
        )
        if return_representations:
            hiddens.append(x)
        if i + 1 in mid_layers:
            selected[i + 1] = x
        if need_head_weights:
            rows.append(row_probs)
            cols.append(col_probs)
    x = layer_norm(model.emb_layer_norm_after, x)

    result = {}
    if return_representations:
        result["representations"] = torch.stack([h0] + hiddens[:-1] + [x.to(h0.dtype)])
    elif repr_layers is not None:
        if 0 in repr_layers:
            selected[0] = h0
        if cfg.num_layers in repr_layers:
            selected[cfg.num_layers] = x  # post-final-LN
        result["representations"] = selected

    result["logits"] = roberta_lm_head(model.lm_head, x.float(), model.embed_tokens.weight,
                                       shard)
    if need_head_weights:
        row_attentions = torch.stack(rows, dim=1).float()   # (B, L, H, C, C)
        result["row_attentions"] = row_attentions
        result["col_attentions"] = torch.stack(cols, dim=1).float()  # (B, L, H, C, R, R)
        if return_contacts:
            result["contacts"] = contact_head(
                model.contact_head, tokens[:, 0, :], row_attentions,
                prepend_bos=cfg.prepend_bos, append_eos=cfg.append_eos, eos_idx=cfg.eos_idx,
            )
    return result
