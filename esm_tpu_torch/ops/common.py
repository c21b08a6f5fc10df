"""Shared functional building blocks: linear layers, layer norms, activations
and the initializers.

Port of esm_tpu/ops/common.py. Parameters live in ``nn.Linear`` /
``nn.LayerNorm`` / ``nn.Embedding`` modules with the reference's layout
(Linear ``weight`` is (out, in)), so reference state dicts load with
``load_state_dict``. Weights are stored in fp32 and cast to the activation
dtype at use, as the JAX package does. Layer norm and softmax always run in
fp32 whatever the compute dtype (the reference forces fp32 softmax,
esm/multihead_attention.py:18-22, and fp32 LayerNorm, esm/modules.py:68-81).
Initializers draw from an explicit ``torch.Generator`` on the parameter's
device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (reference esm/modules.py:17-24)."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


class _Int8Linear(torch.autograd.Function):
    """``F.linear(x, W_q) * scale`` for a weight-only int8 weight W_q (out,
    in) with per-output-channel fp32 scales. The backward saves W_q and the
    scales, not the dequantized weight in x's dtype, and dequantizes again:
    an int8 base then keeps its size until the backward (autograd would hold
    the cast copy of ``F.linear``'s weight for the whole step). The weight
    and the scales take no gradient."""

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        return F.linear(x, w_q.to(x.dtype)) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        w_q, scale = ctx.saved_tensors
        return torch.matmul(dy * scale.to(dy.dtype), w_q.to(dy.dtype)), None, None


def materialize_weight(layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """The (out, in) weight as a dense ``dtype`` matrix (esm_tpu/ops/common.py
    ``materialize_kernel``, transposed): dequantizes a weight-only int8
    weight (esm_tpu_torch/quantization.py), and folds in the delta of LoRA
    factors attached by esm_tpu_torch/lora.py, for the consumers that
    concatenate or hand weights to a kernel instead of calling
    :func:`linear` (the fused tri-mul projections, K7 and K8)."""
    w = layer.weight
    if w.dtype == torch.int8:
        w = w.to(dtype) * layer.scale.to(dtype)[:, None]
    else:
        w = w.to(dtype)
    lora = layer.__dict__.get("lora")
    if lora is not None:
        a, b, scale = lora
        w = w + torch.matmul(a.to(dtype), (b * scale).to(dtype)).t()
    return w


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias, with the weight cast to x's dtype. A weight-only
    int8 weight (esm_tpu_torch/quantization.py) is cast and its
    per-output-channel ``scale`` applied after the product; LoRA factors
    attached by esm_tpu_torch/lora.py's ``patch`` add
    ``(x @ a) @ (b * scale)`` after the bias, the terms in esm_tpu's order."""
    w = layer.weight
    b = layer.bias
    if w.dtype == torch.int8:
        y = _Int8Linear.apply(x, w, layer.scale)
        if b is not None:
            y = y + b.to(y.dtype)
    else:
        y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    lora = layer.__dict__.get("lora")
    if lora is not None:
        a, b_lora, scale = lora
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)), (b_lora * scale).to(x.dtype))
    return y


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standard LN computed in fp32, result in x's dtype
    (reference ESM1bLayerNorm, esm/modules.py:68-81)."""
    y = F.layer_norm(
        x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps
    )
    return y.to(x.dtype)


def softmax_fp32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax computed in fp32, cast back to the input dtype
    (reference utils_softmax, esm/multihead_attention.py:18-22)."""
    return torch.softmax(logits.float(), dim=dim).to(logits.dtype)


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    """Symmetrize the final two dims (reference esm/modules.py:27-29)."""
    return x + x.transpose(-1, -2)


def apc(x: torch.Tensor) -> torch.Tensor:
    """Average-product correction (reference esm/modules.py:32-41)."""
    a1 = x.sum(-1, keepdim=True)
    a2 = x.sum(-2, keepdim=True)
    a12 = x.sum((-1, -2), keepdim=True)
    return x - (a1 * a2) / a12


# ---------------------------------------------------------------------------
# Modules without default init (the initializers below, or a checkpoint load,
# fill them) and the initializers.
# ---------------------------------------------------------------------------


def new_linear(in_dim: int, out_dim: int, bias: bool = True, device=None) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias, device=device or "cpu")


def new_layer_norm(dim: int, device=None) -> nn.LayerNorm:
    return nn.utils.skip_init(nn.LayerNorm, dim, device=device or "cpu")


def new_embedding(vocab: int, dim: int, padding_idx: Optional[int] = None,
                  device=None) -> nn.Embedding:
    return nn.utils.skip_init(nn.Embedding, vocab, dim, padding_idx=padding_idx,
                              device=device or "cpu")


@torch.no_grad()
def init_linear(layer: nn.Linear, generator: torch.Generator, gain: float = 1.0) -> nn.Linear:
    """Xavier-uniform weight (the reference's attention init,
    esm/multihead_attention.py:139-153); zero bias."""
    out_dim, in_dim = layer.weight.shape
    limit = gain * math.sqrt(6.0 / (in_dim + out_dim))
    layer.weight.uniform_(-limit, limit, generator=generator)
    if layer.bias is not None:
        layer.bias.zero_()
    return layer


@torch.no_grad()
def init_linear_torch_default(layer: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """torch.nn.Linear's default init: U(-1/sqrt(in), 1/sqrt(in)) for weight
    and bias (the reference's FFN / LM-head layers)."""
    limit = 1.0 / math.sqrt(layer.weight.shape[1])
    layer.weight.uniform_(-limit, limit, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-limit, limit, generator=generator)
    return layer


@torch.no_grad()
def init_layer_norm(ln: nn.LayerNorm) -> nn.LayerNorm:
    ln.weight.fill_(1.0)
    ln.bias.zero_()
    return ln


@torch.no_grad()
def init_embedding(
    emb: nn.Embedding, generator: torch.Generator, padding_idx: Optional[int] = None
) -> nn.Embedding:
    emb.weight.normal_(generator=generator)
    if padding_idx is not None:
        emb.weight[padding_idx] = 0.0
    return emb
