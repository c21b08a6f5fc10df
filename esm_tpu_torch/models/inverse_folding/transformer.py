"""The encoder-decoder transformer of inverse folding.

Port of esm_tpu/models/inverse_folding/transformer.py (reference semantics:
esm/inverse_folding/transformer_layer.py, transformer_decoder.py): projected
multi-head attention (q scaled by head_dim**-0.5 before the product, -inf
on padded keys, fp32 softmax); the encoder layer (pre-LN, ReLU FFN); the
decoder layer (causal self-attention, cross-attention to the encoder); the
teacher-forced decoder with sinusoidal positions and an untied, bias-free
output projection, returning (B, V, T) logits; and the incremental decode:
``init_decode_cache`` allocates a per-layer KV cache once and
``decoder_step`` writes one position into it in place.

Attention here is plain PyTorch, as it is in the JAX package (no Pallas
kernel there); it does not go through the flash-attention kernel K1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.common import (
    layer_norm,
    linear,
    new_embedding,
    new_layer_norm,
    new_linear,
    softmax_fp32,
)
from ...ops.positional import (
    SinusoidalPositionalEmbedding,
    sinusoidal_positional_embedding,
    sinusoidal_table,
)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    b, t, d = x.shape
    return x.view(b, t, h, d // h).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(q, k, v, *, bias=None, key_padding_mask=None):
    logits = q @ k.transpose(-1, -2)
    if bias is not None:
        logits = logits + bias
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    return softmax_fp32(logits) @ v


class Attention(nn.Module):
    """Parameters of one projected attention (fairseq's MultiheadAttention
    names: q_proj, k_proj, v_proj, out_proj)."""

    def __init__(self, embed_dim: int, kdim: Optional[int] = None, device=None):
        super().__init__()
        kdim = kdim or embed_dim
        self.k_proj = new_linear(kdim, embed_dim, device=device)
        self.v_proj = new_linear(kdim, embed_dim, device=device)
        self.q_proj = new_linear(embed_dim, embed_dim, device=device)
        self.out_proj = new_linear(embed_dim, embed_dim, device=device)


def attention(attn: Attention, query, key, value, *, num_heads: int, key_padding_mask=None,
              attn_mask=None):
    """Projected multi-head attention; ``attn_mask`` (T, S) is added to the
    scores, ``key_padding_mask`` (B, S) is True at keys to leave out."""
    head_dim = query.shape[-1] // num_heads
    q = linear(attn.q_proj, query) * head_dim ** -0.5
    k = linear(attn.k_proj, key)
    v = linear(attn.v_proj, value)
    out = _attend(_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
                  bias=None if attn_mask is None else attn_mask[None, None],
                  key_padding_mask=key_padding_mask)
    return linear(attn.out_proj, _unheads(out))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, device=None):
        super().__init__()
        self.self_attn = Attention(embed_dim, device=device)
        self.self_attn_layer_norm = new_layer_norm(embed_dim, device=device)
        self.fc1 = new_linear(embed_dim, ffn_dim, device=device)
        self.fc2 = new_linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = new_layer_norm(embed_dim, device=device)


class TransformerDecoderLayer(TransformerEncoderLayer):
    def __init__(self, embed_dim: int, encoder_dim: int, ffn_dim: int, device=None):
        super().__init__(embed_dim, ffn_dim, device)
        self.encoder_attn = Attention(embed_dim, kdim=encoder_dim, device=device)
        self.encoder_attn_layer_norm = new_layer_norm(embed_dim, device=device)


def encoder_layer_apply(layer: TransformerEncoderLayer, x, *, num_heads: int,
                        padding_mask=None):
    """(reference transformer_layer.py:61-111), batch-major (B, T, C)."""
    h = layer_norm(layer.self_attn_layer_norm, x)
    x = x + attention(layer.self_attn, h, h, h, num_heads=num_heads,
                      key_padding_mask=padding_mask)
    h = layer_norm(layer.final_layer_norm, x)
    return x + linear(layer.fc2, torch.relu(linear(layer.fc1, h)))


def decoder_layer_apply(layer: TransformerDecoderLayer, x, enc_out, *, num_heads: int,
                        enc_padding_mask=None, self_attn_mask=None,
                        self_attn_padding_mask=None):
    """The teacher-forced layer over the whole sequence (reference
    transformer_layer.py:210-304)."""
    h = layer_norm(layer.self_attn_layer_norm, x)
    x = x + attention(layer.self_attn, h, h, h, num_heads=num_heads,
                      key_padding_mask=self_attn_padding_mask, attn_mask=self_attn_mask)
    h = layer_norm(layer.encoder_attn_layer_norm, x)
    x = x + attention(layer.encoder_attn, h, enc_out, enc_out, num_heads=num_heads,
                      key_padding_mask=enc_padding_mask)
    h = layer_norm(layer.final_layer_norm, x)
    return x + linear(layer.fc2, torch.relu(linear(layer.fc1, h)))


class TransformerDecoder(nn.Module):
    """Token embedding, sinusoidal positions (the ``_float_tensor`` buffer
    only), decoder layers, final LN and the bias-free output projection."""

    def __init__(self, vocab: int, embed_dim: int, encoder_dim: int, ffn_dim: int,
                 num_layers: int, padding_idx: int, device=None):
        super().__init__()
        self.embed_tokens = new_embedding(vocab, embed_dim, padding_idx=padding_idx,
                                          device=device)
        self.embed_positions = SinusoidalPositionalEmbedding(device=device)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, encoder_dim, ffn_dim, device)
            for _ in range(num_layers))
        self.layer_norm = new_layer_norm(embed_dim, device=device)
        self.output_projection = new_linear(embed_dim, vocab, bias=False, device=device)


def decoder_apply(decoder: TransformerDecoder, prev_output_tokens, enc_out, *, num_heads: int,
                  padding_idx: int, enc_padding_mask=None):
    """Teacher-forced decoder (reference transformer_decoder.py:92-210).
    Returns logits (B, V, T), the reference's layout."""
    t = prev_output_tokens.shape[1]
    embed_dim = decoder.embed_tokens.weight.shape[-1]
    x = math.sqrt(embed_dim) * decoder.embed_tokens.weight[prev_output_tokens]
    x = x + sinusoidal_positional_embedding(prev_output_tokens, embed_dim, padding_idx)
    self_attn_padding_mask = prev_output_tokens == padding_idx
    future = torch.triu(torch.full((t, t), float("-inf"), device=x.device), 1)
    for layer in decoder.layers:
        x = decoder_layer_apply(layer, x, enc_out, num_heads=num_heads,
                                enc_padding_mask=enc_padding_mask, self_attn_mask=future,
                                self_attn_padding_mask=self_attn_padding_mask)
    x = layer_norm(decoder.layer_norm, x)
    return linear(decoder.output_projection, x).transpose(1, 2)


@dataclass
class DecoderCache:
    """The incremental decode's state, allocated once and written in place."""
    self_k: torch.Tensor     # (layers, B, H, T_max, Dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (layers, B, H, S, Dh)
    cross_v: torch.Tensor
    # the <pad> positions of the decode prefix: the reference's incremental
    # attention appends each step's key-padding mask to the cached one
    # (multihead_attention.py:306-320), so cached pad keys stay masked
    pad_mask: torch.Tensor   # (B, T_max) bool
    positions: torch.Tensor  # (padding_idx + 1 + T_max, C) sinusoidal table


@torch.no_grad()
def init_decode_cache(decoder: TransformerDecoder, enc_out, *, num_heads: int, max_len: int,
                      padding_idx: int, dtype=torch.float32) -> DecoderCache:
    """The cross-attention keys and values of every layer, computed once, and
    an empty self-attention cache of ``max_len`` positions."""
    b, _, _ = enc_out.shape
    d = decoder.embed_tokens.weight.shape[-1]
    n = len(decoder.layers)
    dev = enc_out.device
    shape = (n, b, num_heads, max_len, d // num_heads)
    return DecoderCache(
        self_k=torch.zeros(shape, dtype=dtype, device=dev),
        self_v=torch.zeros(shape, dtype=dtype, device=dev),
        cross_k=torch.stack([_heads(linear(lp.encoder_attn.k_proj, enc_out), num_heads)
                             for lp in decoder.layers]),
        cross_v=torch.stack([_heads(linear(lp.encoder_attn.v_proj, enc_out), num_heads)
                             for lp in decoder.layers]),
        pad_mask=torch.zeros(b, max_len, dtype=torch.bool, device=dev),
        positions=sinusoidal_table(padding_idx + 1 + max_len, d, padding_idx, device=dev),
    )


@torch.no_grad()
def decoder_step(decoder: TransformerDecoder, token: torch.Tensor, pos: int,
                 cache: DecoderCache, *, num_heads: int, padding_idx: int,
                 enc_padding_mask=None) -> Tuple[torch.Tensor, DecoderCache]:
    """One incremental step: ``token`` (B,) at position ``pos`` (0-based).
    Writes the step's keys and values into ``cache`` in place and returns
    (logits (B, V), cache). Attention reads the cached positions 0..pos:
    later ones are not written yet, and cached <pad> positions are masked."""
    embed_dim = decoder.embed_tokens.weight.shape[-1]
    head_dim = embed_dim // num_heads
    # a <pad> input (a non-target chain in complex sampling) takes the
    # padding_idx row, as the reference's make_positions gives it
    # (esm/modules.py:278-282), not a real position
    is_pad = token == padding_idx
    position = torch.where(is_pad[:, None], cache.positions[padding_idx],
                           cache.positions[padding_idx + 1 + pos])
    x = math.sqrt(embed_dim) * decoder.embed_tokens.weight[token] + position
    x = x[:, None, :]  # (B, 1, C)
    cache.pad_mask[:, pos] = is_pad
    self_mask = cache.pad_mask[:, :pos + 1]

    for i, lp in enumerate(decoder.layers):
        h = layer_norm(lp.self_attn_layer_norm, x)
        q = linear(lp.self_attn.q_proj, h) * head_dim ** -0.5
        cache.self_k[i, :, :, pos] = _heads(linear(lp.self_attn.k_proj, h), num_heads)[:, :, 0]
        cache.self_v[i, :, :, pos] = _heads(linear(lp.self_attn.v_proj, h), num_heads)[:, :, 0]
        out = _attend(_heads(q, num_heads), cache.self_k[i, :, :, :pos + 1],
                      cache.self_v[i, :, :, :pos + 1], key_padding_mask=self_mask)
        x = x + linear(lp.self_attn.out_proj, _unheads(out))

        h = layer_norm(lp.encoder_attn_layer_norm, x)
        q = linear(lp.encoder_attn.q_proj, h) * head_dim ** -0.5
        out = _attend(_heads(q, num_heads), cache.cross_k[i], cache.cross_v[i],
                      key_padding_mask=enc_padding_mask)
        x = x + linear(lp.encoder_attn.out_proj, _unheads(out))

        h = layer_norm(lp.final_layer_norm, x)
        x = x + linear(lp.fc2, torch.relu(linear(lp.fc1, h)))

    x = layer_norm(decoder.layer_norm, x)
    return linear(decoder.output_projection, x)[:, 0], cache
