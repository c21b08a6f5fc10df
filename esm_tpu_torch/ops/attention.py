"""Multi-head self-attention.

Port of esm_tpu/ops/attention.py (reference esm/multihead_attention.py),
batch-major (B, T, D), with two execution paths:
  * ``exact``: matmul attention with an fp32 softmax; can return per-head
    probabilities (the contact head and ``need_head_weights`` need them);
  * ``flash``: kernel K1 (esm_tpu_torch/kernels/flash_attention.py, rotary
    folded in), used when attention maps are not needed; differentiable,
    with kernel K2 as its backward.
  * ``ring``: sequence parallelism (esm_tpu/ops/attention.py:186-208): the
    rows are this rank's block of the sequence, rotated at their global
    positions, and attention runs as a ring over a mesh dimension
    (parallel/ring_attention.py; with ``use_flash``, kernels K4 and K5).

ESM-1's bias_kv (esm_tpu/ops/attention.py:171-182; reference
esm/multihead_attention.py:263-278) appends one learned key/value row to the
source axis, so S = T + 1: the flash path hands K1 those keys with no
rotary, the exact path returns (B, H, T, T + 1) probabilities.

The JAX package's d-major flash branch (esm_tpu/ops/attention.py:141-165,
``DMAJOR_IO_DEFAULT``) laid q/k/v out as (B, H, d, T) for the TPU's 128-wide
lanes; it has no counterpart here: the flash path hands K1 plain
(B, H, T, d) tensors.

Masks: ``key_padding_mask`` is boolean (B, S), True at padding, excluded via
-inf before the fp32 softmax (reference esm/multihead_attention.py:368-374).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..parallel.tensor_parallel import copy_to_tp, gather_from_tp, row_parallel_linear
from .common import linear, new_linear, softmax_fp32
from .rotary import apply_rotary, inv_freq, rotary_tables


class AttentionOutput(NamedTuple):
    out: torch.Tensor                   # (B, T, D)
    probs: Optional[torch.Tensor]       # (B, H, T, S) attention probabilities


class RotaryEmbedding(nn.Module):
    """Holds the reference's ``rot_emb.inv_freq`` buffer so checkpoints load
    key for key; the tables themselves are computed analytically
    (ops/rotary.py), as the JAX package does."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.register_buffer("inv_freq", inv_freq(dim, device))


class SelfAttention(nn.Module):
    """Parameters of one self-attention block, named as the reference's
    MultiheadAttention (q_proj, k_proj, v_proj, out_proj, rot_emb)."""

    def __init__(self, embed_dim: int, num_heads: int, *, use_rotary: bool = True,
                 use_bias_kv: bool = False, device=None):
        super().__init__()
        self.k_proj = new_linear(embed_dim, embed_dim, device=device)
        self.v_proj = new_linear(embed_dim, embed_dim, device=device)
        self.q_proj = new_linear(embed_dim, embed_dim, device=device)
        self.out_proj = new_linear(embed_dim, embed_dim, device=device)
        if use_bias_kv:  # (1, 1, D), as the reference stores them
            self.bias_k = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
            self.bias_v = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        if use_rotary:
            self.rot_emb = RotaryEmbedding(embed_dim // num_heads, device=device)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dh)."""
    b, t, d = x.shape
    return x.view(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, D)."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def multihead_attention(
    attn: SelfAttention,
    x: torch.Tensor,
    *,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    use_rotary: bool = False,
    use_bias_kv: bool = False,
    need_weights: bool = False,
    use_flash: bool = False,
    ring=None,
    tp_group=None,
) -> AttentionOutput:
    """Self-attention over (B, T, D) activations.

    attn_mask: optional additive (T, S) mask broadcast over batch and heads.
    ``use_bias_kv`` (ESM-1) appends ``attn.bias_k``/``bias_v`` as one more
    key/value row that is never masked. ``ring`` = (mesh, axis_name) runs
    sequence parallelism: ``x`` and ``key_padding_mask`` are this rank's
    block of T/N rows of the sequence, the rotary takes the rows' global
    positions, and attention runs as a ring (parallel/ring_attention.py;
    ``use_flash`` selects kernels K4/K5 inside each ring step).
    ``tp_group``: tensor parallelism (parallel/sharding.py): the projections
    hold this tp rank's heads (q/k/v column-parallel, ``num_heads`` the local
    count) and out_proj its input columns (row-parallel, all-reduced);
    attention maps come back with every head.
    """
    if ring is not None and (use_bias_kv or need_weights or attn_mask is not None):
        raise ValueError("ring attention takes no bias_kv key (S = T + 1), no attention "
                         "mask and returns no attention maps")

    b, t, _ = x.shape
    x = copy_to_tp(x, tp_group)
    q = linear(attn.q_proj, x)
    head_dim = q.shape[-1] // num_heads  # a tp rank's projections hold D/tp features
    scaling = head_dim ** -0.5

    q = q * scaling
    k = linear(attn.k_proj, x)
    v = linear(attn.v_proj, x)
    if use_bias_kv:  # under tp, bias_k/bias_v hold this rank's heads' features, as k/v do
        k = torch.cat([k, attn.bias_k.to(k.dtype).expand(b, 1, k.shape[-1])], dim=1)
        v = torch.cat([v, attn.bias_v.to(v.dtype).expand(b, 1, v.shape[-1])], dim=1)
        if key_padding_mask is not None:
            key_padding_mask = torch.cat(
                [key_padding_mask, key_padding_mask.new_zeros(b, 1)], dim=1)
        if attn_mask is not None:
            attn_mask = torch.nn.functional.pad(attn_mask, (0, 1))
    q = _split_heads(q, num_heads)  # (B, H, T, Dh)
    k = _split_heads(k, num_heads)  # (B, H, S, Dh)
    v = _split_heads(v, num_heads)

    if ring is not None:
        from ..kernels.flash_attention import _rotate_f32
        from ..parallel.ring_attention import ring_attention

        mesh, axis_name = ring
        if use_rotary:
            # this rank holds global rows offset .. offset + t - 1; K4 has no
            # rotary, so the rotation runs here (esm_tpu/ops/attention.py:186-192),
            # in fp32 and rounded once, as K1's prologue rotates (esm_tpu rounds
            # the tables to the compute dtype first; the same in fp32)
            offset = mesh.get_local_rank(axis_name) * t
            cos, sin = rotary_tables(offset + t, head_dim, device=x.device)
            q = _rotate_f32(q, cos[offset:], sin[offset:])
            k = _rotate_f32(k, cos[offset:], sin[offset:])
        out = ring_attention(q, k, v, mesh, axis_name=axis_name,
                             key_padding_mask=key_padding_mask, use_flash=use_flash)
        return AttentionOutput(linear(attn.out_proj, _merge_heads(out)), None)

    if use_flash and not need_weights and attn_mask is None:
        from ..kernels.flash_attention import flash_attention

        # rotary runs inside the kernel: position ids are plain row indices
        out = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            key_padding_mask=key_padding_mask, rotary=use_rotary,
        )
        return AttentionOutput(row_parallel_linear(attn.out_proj, _merge_heads(out), tp_group),
                               None)

    if use_rotary:
        # tables sized to the source length; queries use the first T rows
        # (reference esm/rotary_embedding.py:16-20)
        cos, sin = rotary_tables(k.shape[2], head_dim, device=x.device)
        q = apply_rotary(q, cos[:t], sin[:t])
        k = apply_rotary(k, cos, sin)

    logits = torch.matmul(q, k.transpose(-1, -2))
    if attn_mask is not None:
        logits = logits + attn_mask[None, None].to(logits.dtype)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))

    probs = softmax_fp32(logits)
    out = torch.matmul(probs, v)
    out = row_parallel_linear(attn.out_proj, _merge_heads(out), tp_group)
    if need_weights:
        probs = gather_from_tp(probs, 1, tp_group)
    return AttentionOutput(out, probs if need_weights else None)
