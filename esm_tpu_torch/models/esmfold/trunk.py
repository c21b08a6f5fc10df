"""ESMFold folding trunk.

Port of esm_tpu/models/esmfold/trunk.py (reference semantics:
esm/esmfold/v1/trunk.py:110-243): the relative-position pair embedding, the
triangular self-attention blocks, and recycling with the LN'd previous s/z
plus the distogram bins of the previous structure's CB atoms, the structure
module after every pass. The JAX package scans over stacked block params
and recycles; here the blocks are an ``nn.ModuleList`` and both loops are
Python loops. The gradient is stopped on the recycled carry, as in esm_tpu:
every pass but the last reaches the loss only through that carry, so those
passes run without autograd and keep no activations.

With ``pair`` (the sharded fold, ``esmfold.apply_sharded``) every pair
tensor, s_z_0, the recycle carry and bins, the triangle mask and the
relative positions, holds this rank's rows; the sequence track, the
coordinates and the structure module's single state are whole on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.common import layer_norm, linear, new_embedding, new_layer_norm, new_linear
from ..lm_common import embedding_lookup
from .blocks import (
    RelativePosition,
    TriangularSelfAttentionBlock,
    relative_position,
    triangular_self_attention_block,
)
from .structure_module import StructureModule, StructureModuleConfig, structure_module_apply


@dataclass(frozen=True)
class FoldingTrunkConfig:
    num_blocks: int = 48
    sequence_state_dim: int = 1024
    pairwise_state_dim: int = 128
    sequence_head_width: int = 32
    pairwise_head_width: int = 32
    position_bins: int = 32
    max_recycles: int = 4
    chunk_size: Optional[int] = None  # triangle-attention row chunking (memory)
    # the sharded fold: the mesh dimension(s) the pair tensors' rows are split
    # over, e.g. ("tp",) (esm_tpu's PartitionSpec(None, "tp")); the fold then
    # runs through esmfold.apply_sharded on a mesh
    pair_spec: Optional[Tuple[str, ...]] = None
    # compute dtype of the blocks (LN and softmax stay fp32; the structure
    # module always runs fp32)
    compute_dtype: torch.dtype = torch.float32
    use_flash_tri: bool = False  # kernel K6 for triangle attention
    structure_module: StructureModuleConfig = field(default_factory=StructureModuleConfig)

    @property
    def seq_heads(self) -> int:
        return self.sequence_state_dim // self.sequence_head_width

    @property
    def pair_heads(self) -> int:
        return self.pairwise_state_dim // self.pairwise_head_width


RECYCLE_BINS = 15


class FoldingTrunk(nn.Module):
    """The reference FoldingTrunk's parameters (keys ``trunk.*``)."""

    def __init__(self, cfg: FoldingTrunkConfig, device=None):
        super().__init__()
        c_s, c_z = cfg.sequence_state_dim, cfg.pairwise_state_dim
        self.pairwise_positional_embedding = RelativePosition(cfg.position_bins, c_z,
                                                              device=device)
        self.blocks = nn.ModuleList(
            TriangularSelfAttentionBlock(c_s, c_z, cfg.sequence_head_width,
                                         cfg.pairwise_head_width, device=device)
            for _ in range(cfg.num_blocks)
        )
        self.recycle_s_norm = new_layer_norm(c_s, device=device)
        self.recycle_z_norm = new_layer_norm(c_z, device=device)
        self.recycle_disto = new_embedding(RECYCLE_BINS, c_z, device=device)
        self.structure_module = StructureModule(cfg.structure_module, device=device)
        self.trunk2sm_s = new_linear(c_s, cfg.structure_module.c_s, device=device)
        self.trunk2sm_z = new_linear(c_z, cfg.structure_module.c_z, device=device)


def distogram_bins(coords: torch.Tensor, min_bin=3.375, max_bin=21.375,
                   num_bins=RECYCLE_BINS, pair=None) -> torch.Tensor:
    """Coords (..., L, 3, 3) = N/CA/C -> CB distance-bin ids (..., L, L)
    (reference trunk.py:225-243: CB inferred from the backbone); with
    ``pair``, this rank's rows (..., L/N, L)."""
    boundaries = torch.linspace(min_bin, max_bin, num_bins - 1, device=coords.device) ** 2
    n, ca, c = coords[..., 0, :], coords[..., 1, :], coords[..., 2, :]
    b = ca - n
    c_ = c - ca
    a = torch.cross(b, c_, dim=-1)
    cb = -0.58273431 * a + 0.56802827 * b - 0.54067466 * c_ + ca
    rows = cb if pair is None else pair.local(cb, cb.dim() - 2)
    d2 = ((cb[..., None, :, :] - rows[..., :, None, :]) ** 2).sum(-1, keepdim=True)
    return (d2 > boundaries).sum(-1)


def trunk_iter(trunk: FoldingTrunk, cfg: FoldingTrunkConfig, s, z, residx, mask, pair=None):
    s = s.to(cfg.compute_dtype)
    z = z.to(cfg.compute_dtype)
    z = z + relative_position(trunk.pairwise_positional_embedding, residx, mask,
                              bins=cfg.position_bins, pair=pair).to(z.dtype)
    for block in trunk.blocks:
        s, z = triangular_self_attention_block(
            block, s, z, seq_heads=cfg.seq_heads, pair_heads=cfg.pair_heads, mask=mask,
            chunk_size=cfg.chunk_size, use_flash_tri=cfg.use_flash_tri, pair=pair,
        )
    return s.float(), z.float()


def folding_trunk_apply(
    trunk: FoldingTrunk,
    cfg: FoldingTrunkConfig,
    seq_feats: torch.Tensor,
    pair_feats: torch.Tensor,
    true_aa: torch.Tensor,
    residx: torch.Tensor,
    mask: torch.Tensor,
    no_recycles: Optional[int] = None,
    pair=None,
) -> Dict[str, torch.Tensor]:
    """seq_feats: (B, L, c_s); pair_feats: (B, L, L, c_z); residx/mask: (B, L).
    Runs ``no_recycles`` + 1 passes (``max_recycles`` passes when None), the
    structure module after each; returns the last structure with s_s, s_z.
    ``pair``: pair_feats and the returned s_z are this rank's rows."""
    if no_recycles is None:
        no_recycles = cfg.max_recycles
    else:
        if no_recycles < 0:
            raise ValueError(f"num_recycles must be >= 0; got {no_recycles}")
        no_recycles += 1  # the first pass is the standard forward
    s_s = torch.zeros_like(seq_feats)
    s_z = torch.zeros_like(pair_feats)
    bins = torch.zeros(pair_feats.shape[:-1], dtype=torch.int64, device=seq_feats.device)
    grad = torch.is_grad_enabled()
    for pass_ in range(no_recycles):
        last = pass_ + 1 == no_recycles
        with torch.set_grad_enabled(grad and last):
            rs = layer_norm(trunk.recycle_s_norm, s_s.detach())
            rz = layer_norm(trunk.recycle_z_norm, s_z.detach())
            rz = rz + embedding_lookup(trunk.recycle_disto.weight, bins).to(rz.dtype)
            s_s, s_z = trunk_iter(trunk, cfg, seq_feats + rs, pair_feats + rz, residx, mask,
                                  pair)
            structure = structure_module_apply(
                trunk.structure_module, cfg.structure_module,
                linear(trunk.trunk2sm_s, s_s), linear(trunk.trunk2sm_z, s_z), true_aa,
                mask.to(s_s.dtype), pair=pair,
            )
        if not last:
            bins = distogram_bins(structure["positions"][-1][:, :, :3].detach(), pair=pair)
    structure["s_s"] = s_s
    structure["s_z"] = s_z
    return structure
