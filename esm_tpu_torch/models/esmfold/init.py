"""Seeded random ESMFold weights (tests and the chip smoke test; real use
loads a checkpoint).

Port of esm_tpu/models/esmfold/init.py: the same distributions and the same
zero-initialized layers (torch's default Linear init elsewhere, unit
LayerNorms, 0.02·N(0, 1) embeddings, zero ``esm_s_combine`` and IPA head
weights, the gated attention's g_proj a zero weight with a bias of ones).
The numbers differ from JAX's for the same seed: ``torch.Generator`` is not
``jax.random``.
"""

from __future__ import annotations

import fnmatch

import torch
from torch import nn

from ...ops.common import init_linear_torch_default
from .. import esm2
from .esmfold import ESMFold, ESMFoldConfig

# Layers the JAX init zero-initializes, weight and bias (fnmatch patterns
# over module names): every residual branch's last layer, and the
# pair -> sequence bias.
ZERO_LAYERS = (
    "trunk.blocks.*.sequence_to_pair.o_proj", "trunk.blocks.*.pair_to_sequence.linear",
    "trunk.blocks.*.seq_attention.o_proj", "trunk.blocks.*.mlp_seq.mlp.3",
    "trunk.blocks.*.mlp_pair.mlp.3", "trunk.blocks.*.tri_mul_*.linear_z",
    "trunk.blocks.*.tri_att_*.mha.linear_o", "trunk.structure_module.ipa.linear_out",
    "trunk.structure_module.transition.layers.*.linear_3",
    "trunk.structure_module.bb_update.linear",
)


@torch.no_grad()
def init_esmfold(cfg: ESMFoldConfig, generator: torch.Generator, device=None) -> ESMFold:
    """ESMFold (and its LM, through ``esm2.init``) with seeded weights.
    ``generator`` must live on ``device``."""
    lm = esm2.init(cfg.esm, generator, device=device)
    model = ESMFold(cfg, esm=lm, device=device)
    for name, mod in model.named_modules():
        if name.startswith("esm.") or name == "esm":
            continue
        if isinstance(mod, nn.Linear):
            if any(fnmatch.fnmatchcase(name, p) for p in ZERO_LAYERS):
                mod.weight.zero_()
                if mod.bias is not None:
                    mod.bias.zero_()
            else:
                init_linear_torch_default(mod, generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=generator).mul_(0.02)
    for block in model.trunk.blocks:
        block.seq_attention.g_proj.weight.zero_()
        block.seq_attention.g_proj.bias.fill_(1.0)
    model.trunk.structure_module.ipa.head_weights.zero_()
    model.esm_s_combine.zero_()
    return model
