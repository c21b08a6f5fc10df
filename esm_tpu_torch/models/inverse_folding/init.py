"""Seeded random weights for the GVP-Transformer (ESM-IF1) at any size.

The layout and scales of esm_tpu/models/inverse_folding/init.py:25-142: every
linear weight N(0, 1/fan_in), biases zero (``wh`` and ``wv`` of the GVPs and
the output projection have none), LayerNorms and ``Normalize`` unit gain and
zero bias, token embeddings N(0, 1/dim). Draws come from an explicit
``torch.Generator`` that lives on ``device``.
"""

from __future__ import annotations

import torch
from torch import nn

from .features import Normalize
from .model import GVPTransformerConfig, GVPTransformerModel


@torch.no_grad()
def init(cfg: GVPTransformerConfig, generator: torch.Generator,
         device=None) -> GVPTransformerModel:
    model = GVPTransformerModel(cfg, device=device)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(generator=generator).mul_(module.weight.shape[1] ** -0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Normalize):
            module.gain.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(generator=generator).mul_(module.weight.shape[1] ** -0.5)
    return model
