"""Geometric Vector Perceptrons and the GVP graph encoder.

Port of esm_tpu/models/inverse_folding/gvp.py (reference semantics:
esm/inverse_folding/gvp_modules.py, gvp_encoder.py, features.py:258-298):
``GVP`` with vector gating, ``TupleLayerNorm``, ``GVPConv`` message passing,
``GVPConvLayer``, ``GVPGraphEmbedding`` and ``GVPEncoder``. Features are
(s, V) tuples: s (..., ns), V (..., nv, 3).

Message passing keeps the JAX package's dense batched graph: edges are
(B, E) and a message is summed into its destination node over B*L + 1 rows,
the last a dump row for invalid edges, then divided by the clamped edge
count (esm_tpu gvp.py:135-150, a segment_sum there). The sum is
``index_put_(..., accumulate=True)``, which is ``index_add_`` with a fixed
order on CUDA (it sorts the indices and adds each row's messages in edge
order, where ``index_add_`` adds with atomics in whatever order they land),
so a forward repeats bit for bit and a seeded sample repeats token for
token; the per-edge gathers index likewise, so a training step's gradients
repeat too. There is no kernel here: the JAX package has no Pallas kernel for
this model.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ...ops.common import layer_norm, linear, new_layer_norm, new_linear
from .features import edge_features, node_features
from .util import rbf


def _norm_no_nan(x, dim=-1, keepdim=False, eps=1e-8, sqrt=True):
    # the reference ADDS eps (gvp_modules.py:79-88), it does not clamp: the
    # zero-padded orientation vectors at chain ends must give ~0, not sqrt(eps)
    out = torch.sum(torch.square(x), dim=dim, keepdim=keepdim) + eps
    return torch.sqrt(out) if sqrt else out


class GVP(nn.Module):
    """One GVP (reference gvp_modules.py:113-188) in the two forms IF1 uses:
    ``gated`` (ReLU on the scalars, the vectors gated by sigmoid(wg(s))) or
    linear (no activation and no gate: the embedding GVPs and the last GVP
    of each MLP). ``wh`` (vi -> h) and ``wv`` (h -> vo) are bias-free,
    ``ws`` maps [s, |wh(V)|] to so, ``wg`` (so -> vo) exists only when
    gated; h = max(vi, vo)."""

    def __init__(self, in_dims: Tuple[int, int], out_dims: Tuple[int, int], gated: bool,
                 device=None):
        super().__init__()
        si, vi = in_dims
        so, vo = out_dims
        h = max(vi, vo)
        self.gated = gated
        self.wh = new_linear(vi, h, bias=False, device=device)
        self.ws = new_linear(h + si, so, device=device)
        self.wv = new_linear(h, vo, bias=False, device=device)
        if gated:
            self.wg = new_linear(so, vo, device=device)

    def forward(self, s: torch.Tensor, v: torch.Tensor):
        vh = linear(self.wh, v.transpose(-1, -2))            # (..., 3, h)
        s = linear(self.ws, torch.cat([s, _norm_no_nan(vh, dim=-2)], -1))
        v = linear(self.wv, vh).transpose(-1, -2)             # (..., vo, 3)
        if self.gated:
            s = torch.relu(s)
            v = v * torch.sigmoid(linear(self.wg, s)[..., None])
        return s, v


class TupleLayerNorm(nn.Module):
    """LayerNorm for (s, V) tuples (reference gvp_modules.py:256-281): a
    standard LN on s (``scalar_norm``); vectors divided by the rms norm over
    their nonzero channels. The encoder's eps, 1e-4, reaches the vector part
    only: it is the one place it reaches (the message and feed-forward GVPs
    run at 1e-8 in the reference, gvp_modules.py:293-307, 373-381 against
    :367)."""

    eps = 1e-4

    def __init__(self, dims: Tuple[int, int], device=None):
        super().__init__()
        self.scalar_norm = new_layer_norm(dims[0], device=device)

    def forward(self, s: torch.Tensor, v: torch.Tensor):
        eps = self.eps
        vn = _norm_no_nan(v, dim=-1, keepdim=True, sqrt=False, eps=eps)
        nonzero = (vn > 2 * eps).to(v.dtype)
        vn = torch.sum(vn * nonzero, dim=-2, keepdim=True) / (
            eps + torch.sum(nonzero, dim=-2, keepdim=True))
        vn = torch.sqrt(vn + eps)
        return layer_norm(self.scalar_norm, s), nonzero * (v / vn)


def _gather_nodes(s, v, idx):
    """Per-edge node features: s (B, L, ns), v (B, L, nv, 3), idx (B, E) ->
    (B, E, ns), (B, E, nv, 3). Advanced indexing, not ``torch.gather``: its
    backward is the order-fixed ``index_put_(accumulate=True)`` where
    gather's adds with atomics on CUDA, so a training step repeats bit for
    bit too."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return s[rows, idx], v[rows, idx]


class GVPConv(nn.Module):
    """Message per edge = GVP-MLP([source, edge, target] features), averaged
    into the target node (reference gvp_modules.py:267-330; pyg's
    source_to_target flow: source = the centre residue ``src``, target = its
    neighbour ``dst``)."""

    def __init__(self, node_dims, edge_dims, device=None):
        super().__init__()
        ns, nv = node_dims
        es, ev = edge_dims
        self.message_func = nn.ModuleList([
            GVP((2 * ns + es, 2 * nv + ev), node_dims, gated=True, device=device),
            GVP(node_dims, node_dims, gated=True, device=device),
            GVP(node_dims, node_dims, gated=False, device=device)])

    def forward(self, s, v, edge_s, edge_v, src, dst, edge_valid):
        b, l = s.shape[:2]
        s_src, v_src = _gather_nodes(s, v, src)
        s_dst, v_dst = _gather_nodes(s, v, dst)
        ms = torch.cat([s_src, edge_s, s_dst], dim=-1)
        mv = torch.cat([v_src, edge_v, v_dst], dim=-2)
        for gvp in self.message_func:
            ms, mv = gvp(ms, mv)

        valid = edge_valid[..., None].to(ms.dtype)
        ms = ms * valid
        mv = mv * valid[..., None]

        # sum into the destination nodes over flat (batch, node) rows; the
        # invalid edges go to the dump row b*l
        flat = (dst + torch.arange(b, device=dst.device)[:, None] * l).reshape(-1)
        flat = (torch.where(edge_valid.reshape(-1), flat, torch.full_like(flat, b * l)),)

        def segment_sum(x):
            return x.new_zeros(b * l + 1, x.shape[-1]).index_put_(flat, x, accumulate=True)[:-1]

        sum_s = segment_sum(ms.reshape(-1, ms.shape[-1])).reshape(b, l, -1)
        sum_v = segment_sum(mv.reshape(-1, mv.shape[-2] * 3)).reshape(b, l, -1, 3)
        count = segment_sum(edge_valid.reshape(-1, 1).to(ms.dtype)).reshape(b, l, 1)
        count = count.clamp_min(1.0)
        return sum_s / count, sum_v / count[..., None]


class GVPConvLayer(nn.Module):
    """GVPConvLayer (reference gvp_modules.py:331-475, inference): a residual
    GVPConv (3 message GVPs) and a residual GVP feed-forward (2 GVPs through
    (4 ns, 2 nv)), each followed by a tuple LN."""

    def __init__(self, node_dims, edge_dims, device=None):
        super().__init__()
        ns, nv = node_dims
        self.conv = GVPConv(node_dims, edge_dims, device)
        self.norm = nn.ModuleList([TupleLayerNorm(node_dims, device) for _ in range(2)])
        self.ff_func = nn.ModuleList([
            GVP(node_dims, (4 * ns, 2 * nv), gated=True, device=device),
            GVP((4 * ns, 2 * nv), node_dims, gated=False, device=device)])

    def forward(self, s, v, edge_s, edge_v, src, dst, edge_valid):
        dh_s, dh_v = self.conv(s, v, edge_s, edge_v, src, dst, edge_valid)
        s, v = self.norm[0](s + dh_s, v + dh_v)
        fs, fv = s, v
        for gvp in self.ff_func:
            fs, fv = gvp(fs, fv)
        return self.norm[1](s + fs, v + fv)


class GVPGraphEmbedding(nn.Module):
    """Node and edge features embedded by activation-free GVPs and tuple LNs,
    plus an RBF embedding of the confidence (reference features.py:260-298)."""

    def __init__(self, node_dims, edge_dims, top_k: int, device=None):
        super().__init__()
        self.top_k = top_k
        self.embed_node = nn.ModuleList([GVP((7, 3), node_dims, gated=False, device=device),
                                         TupleLayerNorm(node_dims, device)])
        self.embed_edge = nn.ModuleList([GVP((34, 1), edge_dims, gated=False, device=device),
                                         TupleLayerNorm(edge_dims, device)])
        self.embed_confidence = new_linear(16, node_dims[0], device=device)

    def forward(self, coords, coord_mask, padding_mask, confidence):
        with torch.no_grad():  # the reference detaches the raw features
            ns, nv = node_features(coords, coord_mask)
            (edge_s, edge_v), src, dst, edge_valid = edge_features(
                coords, coord_mask, padding_mask, top_k=self.top_k)
        s, v = self.embed_node[1](*self.embed_node[0](ns, nv))
        es, ev = self.embed_edge[1](*self.embed_edge[0](edge_s, edge_v))
        s = s + linear(self.embed_confidence, rbf(confidence, 0.0, 1.0))
        return (s, v), (es, ev), src, dst, edge_valid


class GVPEncoder(nn.Module):
    """GVPEncoder (reference gvp_encoder.py:18-56): the graph embedding, then
    ``num_layers`` GVPConvLayers."""

    def __init__(self, node_dims, edge_dims, top_k: int, num_layers: int, device=None):
        super().__init__()
        self.embed_graph = GVPGraphEmbedding(node_dims, edge_dims, top_k, device)
        self.encoder_layers = nn.ModuleList(
            GVPConvLayer(node_dims, edge_dims, device=device) for _ in range(num_layers))

    def forward(self, coords, coord_mask, padding_mask, confidence):
        (s, v), (es, ev), src, dst, edge_valid = self.embed_graph(
            coords, coord_mask, padding_mask, confidence)
        for layer in self.encoder_layers:
            s, v = layer(s, v, es, ev, src, dst, edge_valid)
        return s, v

