"""ESMFold trunk building blocks.

Port of esm_tpu/models/esmfold/blocks.py (reference semantics:
esm/esmfold/v1/misc.py:150-309 — gated Attention, SequenceToPair,
PairToSequence, ResidueMLP; esm/esmfold/v1/trunk.py:75-107 —
RelativePosition; esm/esmfold/v1/tri_self_attn_block.py:25-160 —
TriangularSelfAttentionBlock). The modules carry the reference's layer
names; the functions run them, inference only (dropout 0).

With ``pair`` (a ``parallel.pair_sharding.PairShard``, the sharded fold)
the pair tensor z is this rank's rows and the sequence track s is whole on
every rank: the pair ops build and update the local rows only, and the
sequence attention takes its queries from the local rows (its pair bias is
theirs) and gathers its output, L·c_s values instead of the L²·H bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..lm_common import embedding_lookup
from ...ops.common import layer_norm, linear, new_embedding, new_layer_norm, new_linear, softmax_fp32
from ...ops.triangle import (
    TriangleAttention,
    TriangleMultiplication,
    triangle_attention,
    triangle_multiplicative_update,
)


def mlp_layers(dim: int, hidden: int, out: int, device=None) -> nn.Sequential:
    """LayerNorm, Linear, ReLU, Linear: the reference's keys .0, .1, .3."""
    return nn.Sequential(new_layer_norm(dim, device=device), new_linear(dim, hidden, device=device),
                         nn.ReLU(), new_linear(hidden, out, device=device))


def mlp_apply(mlp: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(mlp[0], x)
    return linear(mlp[3], torch.relu(linear(mlp[1], h)))


class GatedAttention(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.proj = new_linear(c, 3 * c, bias=False, device=device)
        self.o_proj = new_linear(c, c, device=device)
        self.g_proj = new_linear(c, c, device=device)


class SequenceToPair(nn.Module):
    def __init__(self, c_s: int, c_z: int, device=None):
        super().__init__()
        self.layernorm = new_layer_norm(c_s, device=device)
        self.proj = new_linear(c_s, c_z, device=device)
        self.o_proj = new_linear(c_z, c_z, device=device)


class PairToSequence(nn.Module):
    def __init__(self, c_z: int, heads: int, device=None):
        super().__init__()
        self.layernorm = new_layer_norm(c_z, device=device)
        self.linear = new_linear(c_z, heads, bias=False, device=device)


class ResidueMLP(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.mlp = mlp_layers(dim, 4 * dim, dim, device=device)


class RelativePosition(nn.Module):
    def __init__(self, bins: int, c_z: int, device=None):
        super().__init__()
        self.embedding = new_embedding(2 * bins + 2, c_z, device=device)


class TriangularSelfAttentionBlock(nn.Module):
    def __init__(self, c_s: int, c_z: int, seq_head_width: int, pair_head_width: int,
                 device=None):
        super().__init__()
        self.layernorm_1 = new_layer_norm(c_s, device=device)
        self.sequence_to_pair = SequenceToPair(c_s, c_z, device=device)
        self.pair_to_sequence = PairToSequence(c_z, c_s // seq_head_width, device=device)
        self.seq_attention = GatedAttention(c_s, device=device)
        self.tri_mul_out = TriangleMultiplication(c_z, device=device)
        self.tri_mul_in = TriangleMultiplication(c_z, device=device)
        self.tri_att_start = TriangleAttention(c_z, c_z // pair_head_width, device=device)
        self.tri_att_end = TriangleAttention(c_z, c_z // pair_head_width, device=device)
        self.mlp_seq = ResidueMLP(c_s, device=device)
        self.mlp_pair = ResidueMLP(c_z, device=device)


def gated_attention(
    mod: GatedAttention,
    x: torch.Tensor,
    *,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    pair=None,
) -> torch.Tensor:
    """Gated self-attention with an external pair bias (reference
    esm/esmfold/v1/misc.py:150-211). x: (B, L, C); mask: (B, L), nonzero =
    valid; bias: (B, Lq, Lk, H). ``pair``: bias holds this rank's query
    rows; those rows attend to every key and the output is gathered."""
    b, l, c = x.shape
    w = c // num_heads
    t = linear(mod.proj, x).reshape(b, l, num_heads, 3 * w).transpose(1, 2)  # (B, H, L, 3w)
    q, k, v = t.chunk(3, dim=-1)
    if pair is not None:
        q, x = pair.local(q, 2), pair.local(x)
    q = q * w ** -0.5
    a = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        a = a + bias.permute(0, 3, 1, 2).to(a.dtype)
    if mask is not None:
        a = torch.where(mask[:, None, None, :].bool(), a, float("-inf"))
    a = softmax_fp32(a)
    y = torch.matmul(a, v).transpose(1, 2).reshape(b, x.shape[1], c)
    y = torch.sigmoid(linear(mod.g_proj, x)) * y
    y = linear(mod.o_proj, y)
    if pair is not None:
        from ...parallel.pair_sharding import gather_rows

        y = gather_rows(y, pair)
    return y


def sequence_to_pair(mod: SequenceToPair, s: torch.Tensor, pair=None) -> torch.Tensor:
    """(B, L, C_s) -> (B, L, L, C_z) by outer product and difference
    (reference esm/esmfold/v1/misc.py:237-272); with ``pair``, this rank's
    rows (B, L/N, L, C_z)."""
    s = linear(mod.proj, layer_norm(mod.layernorm, s))
    q, k = s.chunk(2, dim=-1)
    if pair is not None:
        k = pair.local(k)  # row i of the pair tensor reads k[i]
    prod = q[:, None, :, :] * k[:, :, None, :]
    diff = q[:, None, :, :] - k[:, :, None, :]
    return linear(mod.o_proj, torch.cat([prod, diff], dim=-1))


def pair_to_sequence(mod: PairToSequence, z: torch.Tensor) -> torch.Tensor:
    """(B, L, L, C_z) -> (B, L, L, H) attention bias (reference
    esm/esmfold/v1/misc.py:275-293)."""
    return linear(mod.linear, layer_norm(mod.layernorm, z))


def residue_mlp(mod: ResidueMLP, x: torch.Tensor) -> torch.Tensor:
    """x + Linear(ReLU(Linear(LN(x)))) (reference esm/esmfold/v1/misc.py:296-309)."""
    return x + mlp_apply(mod.mlp, x)


def relative_position(
    mod: RelativePosition, residue_index: torch.Tensor, mask: Optional[torch.Tensor] = None,
    *, bins: int = 32, pair=None,
) -> torch.Tensor:
    """Clamped relative-position pair embedding, slot 0 for masked pairs
    (reference esm/esmfold/v1/trunk.py:75-107). Returns the fp32 embedding;
    with ``pair``, this rank's rows."""
    rows = residue_index if pair is None else pair.local(residue_index)
    diff = residue_index[:, None, :] - rows[:, :, None]
    diff = diff.clamp(-bins, bins) + bins + 1
    if mask is not None:
        pair_mask = mask[:, None, :] * (mask if pair is None else pair.local(mask))[:, :, None]
        diff = torch.where(pair_mask.bool(), diff, torch.zeros_like(diff))
    return embedding_lookup(mod.embedding.weight, diff)


def triangular_self_attention_block(
    mod: TriangularSelfAttentionBlock,
    s: torch.Tensor,
    z: torch.Tensor,
    *,
    seq_heads: int,
    pair_heads: int,
    mask: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
    use_flash_tri: bool = False,
    pair=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One trunk block (reference esm/esmfold/v1/tri_self_attn_block.py:106-160):
    pair->seq bias, gated seq attention, seq MLP; seq->pair update, tri-mul
    out/in, tri-attention start/end (kernel K6 with ``use_flash_tri``), pair
    MLP. s: (B, L, C_s); z: (B, L, L, C_z); mask: (B, L). ``pair``: z is this
    rank's rows (B, L/N, L, C_z), s and mask are whole."""
    bias = pair_to_sequence(mod.pair_to_sequence, z)
    y = gated_attention(mod.seq_attention, layer_norm(mod.layernorm_1, s),
                        num_heads=seq_heads, mask=mask, bias=bias, pair=pair)
    s = residue_mlp(mod.mlp_seq, s + y)

    z = z + sequence_to_pair(mod.sequence_to_pair, s, pair)
    tri_mask = None
    if mask is not None:
        rows = mask if pair is None else pair.local(mask)
        tri_mask = (rows[:, :, None] * mask[:, None, :]).to(z.dtype)
    # tri-mul stays unfused here, as in esm_tpu (blocks.py:127-136):
    # triangle_multiplicative_update_fused (K7 + einsum + K8) is the A/B that
    # chip_smoke.py measures against it
    for mul, outgoing in ((mod.tri_mul_out, True), (mod.tri_mul_in, False)):
        z = z + triangle_multiplicative_update(mul, z, outgoing=outgoing, mask=tri_mask,
                                               pair=pair)
    for att, starting in ((mod.tri_att_start, True), (mod.tri_att_end, False)):
        z = z + triangle_attention(att, z, num_heads=pair_heads, starting=starting,
                                   mask=tri_mask, chunk_size=chunk_size, use_flash=use_flash_tri,
                                   pair=pair)
    return s, residue_mlp(mod.mlp_pair, z)
