"""Input features of inverse folding.

Port of esm_tpu/models/inverse_folding/features.py (reference semantics:
esm/inverse_folding/features.py): dihedral cos/sin node scalars;
forward/backward orientations and the idealized side-chain direction as node
vectors; a masked kNN graph over CA with the reference's tie-breaking
(features.py:156-185); distance RBF and sinusoidal relative-position edge
features; ``DihedralFeatures``, the encoder's dihedral embedding.

The graph stays dense and batched: (B, L, K) neighbour indices and
(B, L*K, .) edge features, summed into the nodes in gvp.py.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ...ops.common import linear, new_linear
from .util import nan_to_num, norm, normalize, rbf


def dihedrals(coords: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(B, L, 3+, 3) backbone -> (B, L, 6) cos/sin of phi/psi/omega
    (reference features.py:111-134)."""
    b = coords.shape[0]
    x = coords[:, :, :3].reshape(b, -1, 3)
    dx = x[:, 1:] - x[:, :-1]
    u = normalize(dx, dim=-1)
    u_2, u_1, u_0 = u[:, :-2], u[:, 1:-1], u[:, 2:]
    n_2 = normalize(torch.linalg.cross(u_2, u_1, dim=-1), dim=-1)
    n_1 = normalize(torch.linalg.cross(u_1, u_0, dim=-1), dim=-1)
    cos_d = torch.clamp(torch.sum(n_2 * n_1, -1), -1 + eps, 1 - eps)
    d = torch.sign(torch.sum(u_2 * n_1, -1)) * torch.arccos(cos_d)
    d = nn.functional.pad(d, (1, 2))
    d = d.reshape(b, -1, 3)
    return torch.cat([torch.cos(d), torch.sin(d)], dim=-1)


def orientations(x_ca: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) -> (B, L, 2, 3) forward/backward unit vectors."""
    fwd = normalize(x_ca[:, 1:] - x_ca[:, :-1])
    bwd = normalize(x_ca[:, :-1] - x_ca[:, 1:])
    fwd = nn.functional.pad(fwd, (0, 0, 0, 1))
    bwd = nn.functional.pad(bwd, (0, 0, 1, 0))
    return torch.cat([fwd[:, :, None], bwd[:, :, None]], dim=-2)


def sidechains(coords: torch.Tensor) -> torch.Tensor:
    """(B, L, 3, 3) -> (B, L, 3) idealized CB direction."""
    n, origin, c = coords[:, :, 0], coords[:, :, 1], coords[:, :, 2]
    c = normalize(c - origin)
    n = normalize(n - origin)
    bisector = normalize(c + n)
    perp = normalize(torch.linalg.cross(c, n, dim=-1))
    return -bisector * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)


def node_features(
    coords: torch.Tensor, coord_mask: torch.Tensor, with_coord_mask: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scalars (B, L, 6|7), vectors (B, L, 3, 3))."""
    scalars = dihedrals(coords)
    if with_coord_mask:
        scalars = torch.cat([scalars, coord_mask.to(scalars.dtype)[..., None]], dim=-1)
    x_ca = coords[:, :, 1]
    vec = torch.cat([orientations(x_ca), sidechains(coords)[:, :, None]], dim=-2)
    return scalars, vec


def knn_graph(
    x_ca: torch.Tensor,
    coord_mask: torch.Tensor,
    padding_mask: torch.Tensor,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN over CA with the reference's masked tie-break (features.py:156-185).
    Returns (D_neighbors, E_idx, coord_mask_neighbors, residue_mask_neighbors),
    each (B, L, K).

    Ties are real: a residue without coordinates is ``1e8 + |i-j| 1e6`` from
    both ``i-d`` and ``i+d``. The JAX package's ``lax.top_k`` puts the lower
    index first among equals; a stable ascending sort does the same, where
    ``torch.topk`` promises no order."""
    l = x_ca.shape[1]
    cm2 = coord_mask[:, :, None] & coord_mask[:, None, :]
    rm = ~padding_mask
    rm2 = rm[:, :, None] & rm[:, None, :]
    dx = x_ca[:, :, None] - x_ca[:, None, :]
    d = cm2 * norm(dx, dim=-1)  # NaN for missing residues until nan_to_num

    seqpos = torch.arange(l, device=x_ca.device)
    dseq = (seqpos[:, None] - seqpos[None, :]).abs()[None]
    d_adjust = nan_to_num(d) + (~cm2) * (1e8 + dseq * 1e6) + (~rm2) * 1e10
    k = min(top_k, l)
    d_sorted, order = torch.sort(d_adjust, dim=-1, stable=True)
    d_neighbors, e_idx = d_sorted[..., :k], order[..., :k]
    return d_neighbors, e_idx, d_neighbors < 5e7, d_neighbors < 5e9


def positional_embeddings(offsets: torch.Tensor, num_embeddings: int = 16) -> torch.Tensor:
    """Sinusoidal relative-position features over src-dst offsets
    (reference features.py:139-155)."""
    freq = torch.exp(
        torch.arange(0, num_embeddings, 2, dtype=torch.float32, device=offsets.device)
        * -(math.log(10000.0) / num_embeddings)
    )
    angles = offsets[..., None] * freq
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)


def edge_features(
    coords: torch.Tensor,
    coord_mask: torch.Tensor,
    padding_mask: torch.Tensor,
    *,
    top_k: int,
):
    """Dense edge features (reference features.py:300-352).

    Returns ((edge_s (B, E, 34), edge_v (B, E, 1, 3)), src (B, E), dst (B, E),
    edge_valid (B, E)) with E = L*K. ``src`` is the centre residue, ``dst``
    its neighbour; invalid edges are flagged in ``edge_valid`` (the reference
    sets their index to -1), as are edges to or from residues without
    coordinates."""
    x_ca = coords[:, :, 1]
    d_nb, e_idx, e_coord_mask, e_residue_mask = knn_graph(x_ca, coord_mask, padding_mask, top_k)
    b, l, k = e_idx.shape
    src = torch.arange(l, device=coords.device)[None, :, None].expand(b, l, k).reshape(b, -1)
    dst = e_idx.reshape(b, -1)
    e_dist = d_nb.reshape(b, -1)
    e_coord_mask = e_coord_mask.reshape(b, -1)[..., None]
    e_residue_mask = e_residue_mask.reshape(b, -1)

    pos_emb = positional_embeddings((src - dst).to(torch.float32))
    d_rbf = rbf(e_dist, 0.0, 20.0)

    x_src = torch.gather(x_ca, 1, src[..., None].expand(-1, -1, 3))
    x_dst = torch.gather(x_ca, 1, dst[..., None].expand(-1, -1, 3))
    cm_src = torch.gather(coord_mask, 1, src)
    cm_dst = torch.gather(coord_mask, 1, dst)

    e_vec = x_src - x_dst
    e_mean = torch.sum(e_vec * e_coord_mask, dim=1, keepdim=True) / torch.sum(
        e_coord_mask, dim=1, keepdim=True
    )
    e_vec = torch.where(e_coord_mask, e_vec, e_mean)

    edge_s = nan_to_num(torch.cat([d_rbf, pos_emb], dim=-1))
    edge_v = nan_to_num(normalize(e_vec)[..., None, :])
    edge_s = torch.cat(
        [edge_s, (~cm_src).to(edge_s.dtype)[..., None], (~cm_dst).to(edge_s.dtype)[..., None]],
        dim=-1,
    )
    return (edge_s, edge_v), src, dst, e_residue_mask & e_coord_mask[..., 0]


class Normalize(nn.Module):
    """The reference's ``Normalize`` (features.py:225-256): ``gain`` and
    ``bias`` parameters, the unbiased variance, sigma = sqrt(var + eps) and
    an extra +eps in the denominator."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.gain = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=True)
        sigma = torch.sqrt(var + self.eps)
        return self.gain * (x - mu) / (sigma + self.eps) + self.bias


class DihedralFeatures(nn.Module):
    """Linear embedding of the 6 dihedral features, then ``Normalize``
    (reference features.py:209-256; esm_tpu features.py:176-188)."""

    def __init__(self, node_embed_dim: int, device=None):
        super().__init__()
        self.node_embedding = new_linear(6, node_embed_dim, device=device)
        self.norm_nodes = Normalize(node_embed_dim, device=device)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return self.norm_nodes(linear(self.node_embedding, dihedrals(coords)))
