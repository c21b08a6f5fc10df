"""Axial (row and column) attention over MSA inputs.

Port of esm_tpu/ops/axial_attention.py (reference semantics:
esm/axial_attention.py):
  * row attention is tied across the MSA's rows: the logits are summed over
    the row axis with scaling head_dim^-0.5 / sqrt(R), and padded query
    positions are zeroed before the sum (esm/axial_attention.py:36-99);
  * column attention attends over the rows of each column on its own
    (esm/axial_attention.py:182-222), with a 1-row shortcut;
  * padding is filled with -10000, not -inf, as the reference does: a fully
    padded column then gets uniform probabilities instead of NaN.
Layout: batch-major (B, R, C, D). ``max_rows_per_chunk`` accumulates the row
logits over blocks of rows and ``max_cols_per_chunk`` runs blocks of
columns, which bounds the memory as the reference's chunked inference does
(the sum over rows commutes with the softmax that follows; columns are
independent).

Tensor parallelism (``tp_group``, parallel/sharding.py): the projections
hold this tp rank's heads (q/k/v column-parallel, ``num_heads`` the local
count, the head width taken from the local projection's width) and
out_proj its input columns (row-parallel, all-reduced); the input passes
Megatron's ``copy_to_tp`` once before every chunk's projections, and the
probabilities come back with every head.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.tensor_parallel import _size, copy_to_tp, gather_from_tp, row_parallel_linear
from .common import linear, new_linear, softmax_fp32

PAD_FILL = -10000.0


class AxialAttention(nn.Module):
    """The projections of a RowSelfAttention or ColumnSelfAttention, named as
    the reference's (k_proj, v_proj, q_proj, out_proj)."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.k_proj = new_linear(embed_dim, embed_dim, device=device)
        self.v_proj = new_linear(embed_dim, embed_dim, device=device)
        self.q_proj = new_linear(embed_dim, embed_dim, device=device)
        self.out_proj = new_linear(embed_dim, embed_dim, device=device)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, R, C, D) -> (B, R, C, H, Dh)."""
    b, r, c, d = x.shape
    return x.view(b, r, c, num_heads, d // num_heads)


def row_self_attention(
    attn: AxialAttention,
    x: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: Optional[torch.Tensor] = None,
    max_rows_per_chunk: Optional[int] = None,
    tp_group=None,
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tied row attention. x: (B, R, C, D); padding_mask: (B, R, C) bool.
    Returns (out (B, R, C, D), probs (B, H, C, C), or None without
    ``need_weights``)."""
    b, r, c, _ = x.shape
    x = copy_to_tp(x, tp_group)

    def chunk_logits(rows: slice) -> torch.Tensor:
        q = _heads(linear(attn.q_proj, x[:, rows]), num_heads)
        q = q * (q.shape[-1] ** -0.5 / (r ** 0.5))
        k = _heads(linear(attn.k_proj, x[:, rows]), num_heads)
        if padding_mask is not None:
            q = q * (1.0 - padding_mask[:, rows, :, None, None].to(q.dtype))
        return torch.einsum("brihd,brjhd->bhij", q, k)

    if max_rows_per_chunk is None or max_rows_per_chunk >= r:
        w = chunk_logits(slice(None))
    else:
        w = chunk_logits(slice(0, max_rows_per_chunk))
        for start in range(max_rows_per_chunk, r, max_rows_per_chunk):
            w = w + chunk_logits(slice(start, start + max_rows_per_chunk))
    if padding_mask is not None:
        # keys masked by the first row's padding (reference esm/axial_attention.py:93-97)
        w = w.masked_fill(padding_mask[:, 0][:, None, None, :], PAD_FILL)

    probs = softmax_fp32(w)
    v = _heads(linear(attn.v_proj, x), num_heads)
    ctx = torch.einsum("bhij,brjhd->brihd", probs.to(v.dtype), v)
    out = row_parallel_linear(attn.out_proj, ctx.reshape(b, r, c, -1), tp_group)
    return out, gather_from_tp(probs, 1, tp_group) if need_weights else None


def column_self_attention(
    attn: AxialAttention,
    x: torch.Tensor,
    *,
    num_heads: int,
    padding_mask: Optional[torch.Tensor] = None,
    max_cols_per_chunk: Optional[int] = None,
    tp_group=None,
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention over the rows of each column. x: (B, R, C, D).
    Returns (out (B, R, C, D), probs (B, H, C, R, R), or None without
    ``need_weights``)."""
    b, r, c, _ = x.shape
    x = copy_to_tp(x, tp_group)
    if r == 1:
        # one row: attention is the identity over the row axis
        # (reference esm/axial_attention.py:189-200)
        out = row_parallel_linear(attn.out_proj, linear(attn.v_proj, x), tp_group)
        heads = num_heads * _size(tp_group)
        probs = torch.ones((b, heads, c, 1, 1), dtype=x.dtype, device=x.device)
        return out, probs if need_weights else None
    if max_cols_per_chunk is None or max_cols_per_chunk >= c:
        out, probs = _columns(attn, x, num_heads, padding_mask, tp_group)
    else:
        parts = [
            _columns(attn, x[:, :, start:start + max_cols_per_chunk], num_heads,
                     None if padding_mask is None
                     else padding_mask[:, :, start:start + max_cols_per_chunk], tp_group)
            for start in range(0, c, max_cols_per_chunk)
        ]
        out = torch.cat([o for o, _ in parts], dim=2)
        probs = torch.cat([p for _, p in parts], dim=2)
    return out, gather_from_tp(probs, 1, tp_group) if need_weights else None


def _columns(attn, x, num_heads, padding_mask, tp_group):
    """Column attention over a block of columns of ``x`` (R > 1), already
    past ``copy_to_tp``: (out, this rank's heads' probs)."""
    b, r, c, _ = x.shape
    q = _heads(linear(attn.q_proj, x), num_heads)
    q = q * q.shape[-1] ** -0.5
    k = _heads(linear(attn.k_proj, x), num_heads)
    v = _heads(linear(attn.v_proj, x), num_heads)
    w = torch.einsum("bichd,bjchd->bhcij", q, k)   # (B, H, C, R_query, R_key)
    if padding_mask is not None:
        keys_padded = padding_mask.transpose(1, 2)  # (B, C, R)
        w = w.masked_fill(keys_padded[:, None, :, None, :], PAD_FILL)
    probs = softmax_fp32(w)
    ctx = torch.einsum("bhcij,bjchd->bichd", probs.to(v.dtype), v)
    return row_parallel_linear(attn.out_proj, ctx.reshape(b, r, c, -1), tp_group), probs
