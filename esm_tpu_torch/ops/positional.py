"""Positional embeddings, learned and sinusoidal.

Port of esm_tpu/ops/positional.py (reference semantics: esm/modules.py:224-295).
Both schemes derive positions from the tokens themselves, offset by
padding_idx (the fairseq convention the checkpoints carry): position ids
start at padding_idx + 1 and a padded slot gets padding_idx, whose row is
zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def learned_positions(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """Position ids = cumsum of the non-pad mask + padding_idx; pads get
    padding_idx (reference esm/modules.py:240-257)."""
    mask = (tokens != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def learned_positional_embedding(
    embed: nn.Embedding, tokens: torch.Tensor, padding_idx: int, max_positions: int
) -> torch.Tensor:
    """``embed``: (max_positions + padding_idx + 1, D). Raises past
    max_positions tokens, as the reference does (esm/modules.py:242-245)."""
    if tokens.shape[1] > max_positions:
        raise ValueError(
            f"Sequence length {tokens.shape[1]} above maximum sequence length "
            f"of {max_positions}"
        )
    return torch.nn.functional.embedding(learned_positions(tokens, padding_idx), embed.weight)


def sinusoidal_table(num_embeddings: int, embed_dim: int, padding_idx: int,
                     device=None) -> torch.Tensor:
    """fp32 (num_embeddings, embed_dim) table in fairseq's layout: [sin | cos]
    halves, a zero row at padding_idx (reference esm/modules.py:284-295)."""
    half_dim = embed_dim // 2
    step = math.log(10000) / (half_dim - 1)
    freq = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=device) * -step)
    arg = torch.arange(num_embeddings, dtype=torch.float32, device=device)[:, None] * freq[None]
    emb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)
    if embed_dim % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros(num_embeddings, 1)], dim=1)
    emb[padding_idx] = 0.0
    return emb


def sinusoidal_positional_embedding(
    tokens: torch.Tensor, embed_dim: int, padding_idx: int
) -> torch.Tensor:
    """Stateless sinusoidal embedding (reference esm/modules.py:260-295).
    Positions are index-based, not cumsum-based: padding_idx + 1 + t for a
    real token at column t, padding_idx at pads (reference make_positions,
    esm/modules.py:278-282). Returns fp32 (B, T, D)."""
    seq_len = tokens.shape[1]
    table = sinusoidal_table(padding_idx + 1 + seq_len, embed_dim, padding_idx,
                             device=tokens.device)
    columns = torch.arange(seq_len, device=tokens.device)[None, :] + padding_idx + 1
    positions = torch.where(tokens != padding_idx, columns, padding_idx)
    return table[positions]


class SinusoidalPositionalEmbedding(nn.Module):
    """Holds the reference's ``embed_positions._float_tensor`` buffer (a
    dtype carrier, esm/modules.py:260-270) so ESM-1 checkpoints load key for
    key; the table itself is computed, as the JAX package does."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("_float_tensor", torch.zeros(1, device=device))
