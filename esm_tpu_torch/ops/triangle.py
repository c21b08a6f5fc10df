"""Triangle multiplicative updates and triangle attention (the ESMFold
trunk's pair ops).

Port of esm_tpu/ops/triangle.py (the openfold modules the reference uses,
esm/esmfold/v1/tri_self_attn_block.py:6-13,58-77; AF2 Algorithms 11-14):

  * outgoing multiplication:  x[i,j] = Σ_k a[i,k] ⊙ b[j,k]
  * incoming multiplication:  x[i,j] = Σ_k a[k,i] ⊙ b[k,j]
  * starting-node attention:  rows attend over j with a bias from z
  * ending-node attention:    transpose, the same, transpose back

The modules hold the reference's layer names, so checkpoint keys load as
they are. With ``pair`` (a ``parallel.pair_sharding.PairShard``) z holds
this rank's rows of the pair tensor and each op computes those rows of its
update (the sharded fold): the outgoing product gathers b over rows, the
incoming one moves a to column sharding and gathers b, starting-node
attention gathers its (B, L, L, H) bias and attends on the local rows, and
ending-node attention runs the starting-node op on the row shard of zᵀ.
The O(L³·C) einsums stay ``torch.einsum`` (cuBLAS), as they stayed in XLA. Triangle attention has three paths, as in JAX: exact (the
(B, I, H, J, J) logits materialized), chunked over rows (memory only), and
fused (kernel K6, ``use_flash``). ``triangle_multiplicative_update_fused``
runs kernels K7 and K8 around the einsum.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import (
    layer_norm,
    linear,
    materialize_weight,
    new_layer_norm,
    new_linear,
    softmax_fp32,
)


class TriangleMultiplication(nn.Module):
    """openfold TriangleMultiplication{Outgoing,Incoming} parameters."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.layer_norm_in = new_layer_norm(c, device=device)
        self.layer_norm_out = new_layer_norm(c, device=device)
        for name in ("linear_a_p", "linear_a_g", "linear_b_p", "linear_b_g", "linear_g",
                     "linear_z"):
            setattr(self, name, new_linear(c, c, device=device))


class TriangleAttentionMHA(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        for name in ("linear_q", "linear_k", "linear_v"):
            setattr(self, name, new_linear(c, c, bias=False, device=device))
        self.linear_o = new_linear(c, c, device=device)
        self.linear_g = new_linear(c, c, device=device)


class TriangleAttention(nn.Module):
    """openfold TriangleAttention parameters (layer_norm, linear, mha.*)."""

    def __init__(self, c: int, num_heads: int, device=None):
        super().__init__()
        self.layer_norm = new_layer_norm(c, device=device)
        self.linear = new_linear(c, num_heads, bias=False, device=device)
        self.mha = TriangleAttentionMHA(c, device=device)


_FIVE = ("linear_a_g", "linear_a_p", "linear_b_g", "linear_b_p", "linear_g")


def _einsum(a: torch.Tensor, b: torch.Tensor, outgoing: bool) -> torch.Tensor:
    if outgoing:
        return torch.einsum("bikc,bjkc->bijc", a, b)
    return torch.einsum("bkic,bkjc->bijc", a, b)


def triangle_multiplicative_update(
    mod: TriangleMultiplication,
    z: torch.Tensor,
    *,
    outgoing: bool,
    mask: Optional[torch.Tensor] = None,
    pair=None,
) -> torch.Tensor:
    """z: (B, I, J, C); mask: (B, I, J). Returns the residual update. The
    five C-wide projections of LN(z) run as one (C, 5C) product, as in JAX
    (:42-52): column for column the same numbers. ``pair``: z and mask are
    this rank's rows, and so is the update."""
    if mask is None:
        mask = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
    mask = mask[..., None].to(z.dtype)
    zn = layer_norm(mod.layer_norm_in, z)
    c = zn.shape[-1]
    w = torch.cat([materialize_weight(getattr(mod, n), zn.dtype) for n in _FIVE], dim=0)
    bias = torch.cat([getattr(mod, n).bias for n in _FIVE]).to(zn.dtype)
    p = torch.nn.functional.linear(zn, w) + bias
    a_g, a_p, b_g, b_p, g_l = p.split(c, dim=-1)
    a = mask * torch.sigmoid(a_g) * a_p
    b = mask * torch.sigmoid(b_g) * b_p
    if pair is not None:
        # out[i, j] = sum_k a[i, k] b[j, k]: every row j of b; in[i, j] =
        # sum_k a[k, i] b[k, j]: a's columns i over every k, and every b
        from ..parallel.pair_sharding import gather_rows, rows_to_cols

        a = a if outgoing else rows_to_cols(a, pair)
        b = gather_rows(b, pair)
    x = _einsum(a, b, outgoing)
    x = layer_norm(mod.layer_norm_out, x)
    x = linear(mod.linear_z, x)
    return x * torch.sigmoid(g_l)


def triangle_multiplicative_update_fused(
    mod: TriangleMultiplication,
    z: torch.Tensor,
    *,
    outgoing: bool,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7 + einsum + K8: returns ``z + update`` (the residual add is in the
    epilogue kernel). ``mask=None`` runs stage 1 with no mask stream. Same
    math as :func:`triangle_multiplicative_update`."""
    from ..kernels.triangle_mul import tri_mul_epilogue, tri_mul_stage1

    a, b = tri_mul_stage1(z, mask, mod)
    return tri_mul_epilogue(_einsum(a, b, outgoing), z, mod)


def _gated_output(mha: TriangleAttentionMHA, o: torch.Tensor, zr: torch.Tensor) -> torch.Tensor:
    return linear(mha.linear_o, o * torch.sigmoid(linear(mha.linear_g, zr)))


def _attend_rows(mha, zr, mb, tri_bias, num_heads):
    """Exact attention of rows zr (B, ci, J, C) with the mask bias mb
    (B, ci, 1, 1, J) and the triangle bias (B, 1, H, J, J)."""
    b, ci, j, c = zr.shape
    hd = c // num_heads

    def heads(t):
        return t.reshape(b, ci, j, num_heads, hd).transpose(2, 3)  # (B, ci, H, J, hd)

    q = heads(linear(mha.linear_q, zr)) / math.sqrt(hd)
    k = heads(linear(mha.linear_k, zr))
    v = heads(linear(mha.linear_v, zr))
    a = torch.matmul(q, k.transpose(-1, -2))
    a = a + mb
    a = a + tri_bias
    a = softmax_fp32(a)
    o = torch.matmul(a, v).transpose(2, 3).reshape(b, ci, j, c)
    return _gated_output(mha, o, zr)


def triangle_attention(
    mod: TriangleAttention,
    z: torch.Tensor,
    *,
    num_heads: int,
    starting: bool,
    mask: Optional[torch.Tensor] = None,
    inf: float = 1e9,
    chunk_size: Optional[int] = None,
    use_flash: bool = False,
    pair=None,
) -> torch.Tensor:
    """z: (B, I, J, C); mask: (B, I, J). Gated multi-head attention over the J
    axis per row (starting) or over I per column (ending). Returns the
    residual update.

    Masked keys get ``inf·(mask - 1)`` on the exact and chunked paths and
    -1e30 on the fused path, as in JAX (:121, :166); the two differ only on
    rows whose keys are all masked, which no real row reads.
    ``chunk_size``: this many rows at a time on the exact path (memory, not
    numerics). ``use_flash``: kernel K6 (on CUDA it launches the kernel or
    raises). ``pair``: z and mask are this rank's rows (B, L/N, L, ·), and so
    is the update; the triangle bias is gathered whole, and the local rows
    attend as the whole tensor's would (``chunk_size`` chunks them)."""
    if mask is None:
        mask = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
    if not starting:
        if pair is None:
            z = z.transpose(-2, -3)
            mask = mask.transpose(-1, -2)
        else:
            from ..parallel.pair_sharding import transpose_rows

            z = transpose_rows(z, pair)
            mask = transpose_rows(mask, pair)

    zn = layer_norm(mod.layer_norm, z)
    tri = linear(mod.linear, zn)  # (B, I, J, H): bias rows are query positions
    if pair is not None:
        from ..parallel.pair_sharding import gather_rows

        tri = gather_rows(tri, pair)  # (B, J, J, H)
    b, i, j, c = zn.shape
    mha = mod.mha

    if use_flash:
        from ..kernels.triangle_attention import NEG_INF, triangle_attention_fused

        hd = c // num_heads

        def heads(t):
            return t.reshape(b, i, j, num_heads, hd)  # (B, I, J, H, d): no transpose

        q = (heads(linear(mha.linear_q, zn)) / math.sqrt(hd)).contiguous()
        k = heads(linear(mha.linear_k, zn)).contiguous()
        v = heads(linear(mha.linear_v, zn)).contiguous()
        tri_b = tri.permute(0, 3, 1, 2).float().contiguous()  # (B, H, J, J)
        key_bias = torch.where(mask > 0, 0.0, NEG_INF).float().contiguous()  # (B, I, J)
        o = triangle_attention_fused(q, k, v, tri_b, key_bias).reshape(b, i, j, c)
        o = _gated_output(mha, o, zn)
    else:
        mask_bias = (inf * (mask - 1.0))[..., :, None, None, :]  # (B, I, 1, 1, J)
        tri_bias = tri.permute(0, 3, 1, 2)[:, None]               # (B, 1, H, J, J)
        if chunk_size is None or chunk_size >= i:
            o = _attend_rows(mha, zn, mask_bias, tri_bias, num_heads)
        else:
            o = torch.cat([
                _attend_rows(mha, zn[:, s:s + chunk_size], mask_bias[:, s:s + chunk_size],
                             tri_bias, num_heads)
                for s in range(0, i, chunk_size)
            ], dim=1)

    if not starting:
        o = o.transpose(-2, -3) if pair is None else transpose_rows(o, pair)
    return o
