"""AF2-style structure module.

Port of esm_tpu/models/esmfold/structure_module.py (reference: openfold's
StructureModule as ESMFold uses it, esm/esmfold/v1/trunk.py:11,144,203-207;
AF2 Algorithms 20-24): invariant point attention, shared weights over
``no_blocks`` iterations, quaternion backbone updates, the angle resnet, and
torsions -> rigid-group frames -> atom14 coordinates from the literature
tables in ``esm_tpu_torch/data/residue_constants.npz``. It always runs in
fp32 (geometry is precision-sensitive); the IPA's point-distance cross term
is a matrix product computed with TF32 off whatever the global setting.

With ``pair`` (the sharded fold) z is this rank's rows of the pair
tensor and everything else is whole: IPA's pair terms (the ``linear_b``
bias and ``o_pair``) are row-local, so IPA attends from the local query
rows to every key and gathers its (B, L/N, c_s) output; z is never gathered.

Config (reference esm/esmfold/v1/trunk.py:16-32): c_s 384, c_z 128, c_ipa
16, 12 IPA heads, 4 qk / 8 v points, 8 blocks, 7 angles, translation scale 10.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...data import residue_constants as rc
from ...ops import rigid as rg
from ...ops.common import layer_norm, linear, new_layer_norm, new_linear, softmax_fp32


@dataclass(frozen=True)
class StructureModuleConfig:
    c_s: int = 384
    c_z: int = 128
    c_ipa: int = 16
    c_resnet: int = 128
    no_heads_ipa: int = 12
    no_qk_points: int = 4
    no_v_points: int = 8
    dropout_rate: float = 0.1
    no_blocks: int = 8
    no_transition_layers: int = 1
    no_resnet_blocks: int = 2
    no_angles: int = 7
    trans_scale_factor: int = 10
    epsilon: float = 1e-8
    inf: float = 1e5


class InvariantPointAttention(nn.Module):
    def __init__(self, cfg: StructureModuleConfig, device=None):
        super().__init__()
        h, c, pq, pv = cfg.no_heads_ipa, cfg.c_ipa, cfg.no_qk_points, cfg.no_v_points
        self.linear_q = new_linear(cfg.c_s, h * c, device=device)
        self.linear_kv = new_linear(cfg.c_s, 2 * h * c, device=device)
        self.linear_q_points = new_linear(cfg.c_s, h * pq * 3, device=device)
        self.linear_kv_points = new_linear(cfg.c_s, h * (pq + pv) * 3, device=device)
        self.linear_b = new_linear(cfg.c_z, h, device=device)
        self.head_weights = nn.Parameter(torch.zeros(h, device=device))
        self.linear_out = new_linear(h * (cfg.c_z + c + pv * 4), cfg.c_s, device=device)


class _Linears(nn.Module):
    def __init__(self, names, dims, device=None):
        super().__init__()
        for name, (i, o) in zip(names, dims):
            setattr(self, name, new_linear(i, o, device=device))


class Transition(nn.Module):
    def __init__(self, cfg: StructureModuleConfig, device=None):
        super().__init__()
        c = cfg.c_s
        self.layers = nn.ModuleList(
            _Linears(("linear_1", "linear_2", "linear_3"), ((c, c),) * 3, device=device)
            for _ in range(cfg.no_transition_layers)
        )
        self.layer_norm = new_layer_norm(c, device=device)


class AngleResnet(nn.Module):
    def __init__(self, cfg: StructureModuleConfig, device=None):
        super().__init__()
        r = cfg.c_resnet
        self.linear_in = new_linear(cfg.c_s, r, device=device)
        self.linear_initial = new_linear(cfg.c_s, r, device=device)
        self.layers = nn.ModuleList(
            _Linears(("linear_1", "linear_2"), ((r, r),) * 2, device=device)
            for _ in range(cfg.no_resnet_blocks)
        )
        self.linear_out = new_linear(r, cfg.no_angles * 2, device=device)


class StructureModule(nn.Module):
    """openfold StructureModule parameters under the reference's names."""

    def __init__(self, cfg: StructureModuleConfig, device=None):
        super().__init__()
        self.layer_norm_s = new_layer_norm(cfg.c_s, device=device)
        self.layer_norm_z = new_layer_norm(cfg.c_z, device=device)
        self.linear_in = new_linear(cfg.c_s, cfg.c_s, device=device)
        self.ipa = InvariantPointAttention(cfg, device=device)
        self.layer_norm_ipa = new_layer_norm(cfg.c_s, device=device)
        self.transition = Transition(cfg, device=device)
        self.bb_update = _Linears(("linear",), ((cfg.c_s, 6),), device=device)
        self.angle_resnet = AngleResnet(cfg, device=device)


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """A residue-constants table on ``device`` (int64 for index tables)."""
    a = np.asarray(getattr(rc, name))
    t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
    return t.to(device)


def table(name: str, aatype: torch.Tensor) -> torch.Tensor:
    """``residue_constants.<name>`` indexed by residue type."""
    return _table(name, aatype.device)[aatype]


@contextlib.contextmanager
def _full_fp32_matmul():
    """Matrix products in full fp32 (TF32 off) inside, whatever the global
    setting; restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _global_points(t: torch.Tensor, r: rg.Rigid, b: int, l: int, h: int, n: int):
    """(B, L, h*n*3) point projections, laid out as openfold splits them
    (all x, then y, then z), into the global frame: (B, L, h, n, 3)."""
    xyz = torch.stack(t.chunk(3, dim=-1), dim=-1)  # (B, L, h*n, 3)
    xyz = rg.apply(r.unsqueeze(-1), xyz)
    return xyz.reshape(b, l, h, n, 3)


def invariant_point_attention(
    mod: InvariantPointAttention,
    cfg: StructureModuleConfig,
    s: torch.Tensor,
    z: torch.Tensor,
    r: rg.Rigid,
    mask: torch.Tensor,
    pair=None,
) -> torch.Tensor:
    """IPA (AF2 Alg. 22). s: (B, L, c_s); z: (B, L, L, c_z); r over (B, L);
    mask: (B, L). Returns the s update (B, L, c_s). ``pair``: z is this
    rank's rows (B, L/N, L, c_z)."""
    b, l, _ = s.shape
    h, c = cfg.no_heads_ipa, cfg.c_ipa
    pq, pv = cfg.no_qk_points, cfg.no_v_points
    # the query rows: this rank's with pair, else all
    sq, rq, mq = (s, r, mask) if pair is None else (pair.local(s), r[:, pair.row_slice],
                                                    pair.local(mask))
    lq = sq.shape[1]

    q = linear(mod.linear_q, sq).reshape(b, lq, h, c)
    k, v = linear(mod.linear_kv, s).reshape(b, l, h, 2 * c).split(c, dim=-1)
    q_pts = _global_points(linear(mod.linear_q_points, sq), rq, b, lq, h, pq)
    kv_pts = _global_points(linear(mod.linear_kv_points, s), r, b, l, h, pq + pv)
    k_pts, v_pts = kv_pts.split([pq, pv], dim=-2)

    bias = linear(mod.linear_b, z)  # (B, L, L, H)
    a = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))  # (B, H, Li, Lj)
    a = a * math.sqrt(1.0 / (3 * c))
    a = a + math.sqrt(1.0 / 3) * bias.permute(0, 3, 1, 2)

    # sum_p |q - k|^2 = sum_p |q|^2 + sum_p |k|^2 - 2 sum_p q.k: the cross term
    # is one product with an O(L^2.H) output instead of an O(L^2.H.P.3)
    # difference tensor; it cancels against large |q|^2 + |k|^2 terms, so it
    # runs in full fp32 (esm_tpu: precision=HIGHEST)
    head_w = torch.nn.functional.softplus(mod.head_weights) * math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
    qq = (q_pts * q_pts).sum((-1, -2))  # (B, L, H)
    kk = (k_pts * k_pts).sum((-1, -2))
    with _full_fp32_matmul():
        qk = torch.matmul(q_pts.reshape(b, lq, h, pq * 3).transpose(1, 2),
                          k_pts.reshape(b, l, h, pq * 3).permute(0, 2, 3, 1))
    d2 = qq.transpose(1, 2)[..., :, None] + kk.transpose(1, 2)[..., None, :] - 2.0 * qk
    a = a + d2 * (head_w[None, :, None, None] * -0.5)

    square_mask = mq[:, :, None] * mask[:, None, :]
    a = a + (cfg.inf * (square_mask - 1.0))[:, None]
    a = softmax_fp32(a)

    o = torch.matmul(a, v.transpose(1, 2)).transpose(1, 2).reshape(b, lq, h * c)
    o_pt = torch.matmul(a, v_pts.reshape(b, l, h, pv * 3).transpose(1, 2))  # (B, H, Lq, pv*3)
    o_pt = o_pt.reshape(b, h, lq, pv, 3).permute(0, 2, 1, 3, 4)           # (B, Lq, H, pv, 3)
    o_pt = rg.invert_apply(rq.unsqueeze(-1).unsqueeze(-1), o_pt)
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + cfg.epsilon).reshape(b, lq, h * pv)
    o_pt_flat = o_pt.reshape(b, lq, h * pv, 3)
    o_pair = torch.matmul(a.transpose(1, 2), z).reshape(b, lq, h * cfg.c_z)  # (B, Lq, H, c_z)

    # concatenated as openfold does: scalar, point x, y, z, point norms, pair
    cat = torch.cat([o, o_pt_flat[..., 0], o_pt_flat[..., 1], o_pt_flat[..., 2], o_pt_norm,
                     o_pair], dim=-1)
    out = linear(mod.linear_out, cat)
    if pair is not None:
        from ...parallel.pair_sharding import gather_rows

        out = gather_rows(out, pair)
    return out


def angle_resnet(mod: AngleResnet, cfg: StructureModuleConfig, s, s_initial):
    """AF2 Alg. 20 lines 11-14. Returns (unnormalized, normalized) (..., 7, 2)."""
    s = linear(mod.linear_in, torch.relu(s)) + linear(mod.linear_initial, torch.relu(s_initial))
    for layer in mod.layers:
        a = linear(layer.linear_2, torch.relu(linear(layer.linear_1, torch.relu(s))))
        s = s + a
    s = linear(mod.linear_out, torch.relu(s))
    s = s.reshape(s.shape[:-1] + (cfg.no_angles, 2))
    denom = torch.sqrt(torch.clamp_min((s ** 2).sum(-1, keepdim=True), cfg.epsilon))
    return s, s / denom


def transition(mod: Transition, s: torch.Tensor) -> torch.Tensor:
    for layer in mod.layers:
        h = linear(layer.linear_1, s)
        h = linear(layer.linear_2, torch.relu(h))
        h = linear(layer.linear_3, torch.relu(h))
        s = s + h
    return layer_norm(mod.layer_norm, s)


def torsion_angles_to_frames(r: rg.Rigid, alpha: torch.Tensor, aatype: torch.Tensor) -> rg.Rigid:
    """Default frames composed with x-axis torsion rotations, chi frames
    chained, mapped to the global frame (openfold
    feats.torsion_angles_to_frames)."""
    default_r = rg.from_tensor_4x4(table("restype_rigid_group_default_frame", aatype))
    bb_rot = torch.zeros(alpha.shape[:-2] + (1, 2), dtype=alpha.dtype, device=alpha.device)
    bb_rot[..., 1] = 1.0
    alpha = torch.cat([bb_rot, alpha], dim=-2)  # (..., 8, 2)

    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros, ones = torch.zeros_like(sin_a), torch.ones_like(sin_a)
    all_rots = torch.stack(
        [ones, zeros, zeros, zeros, cos_a, -sin_a, zeros, sin_a, cos_a], dim=-1
    ).reshape(sin_a.shape + (3, 3))
    all_frames = rg.compose(default_r, rg.Rigid(all_rots, torch.zeros_like(default_r.trans)))

    chi2 = rg.compose(all_frames[..., 4], all_frames[..., 5])
    chi3 = rg.compose(chi2, all_frames[..., 6])
    chi4 = rg.compose(chi3, all_frames[..., 7])
    parts = [all_frames[..., :5], chi2.unsqueeze(-1), chi3.unsqueeze(-1), chi4.unsqueeze(-1)]
    to_bb = rg.Rigid(torch.cat([p.rots for p in parts], dim=-3),
                     torch.cat([p.trans for p in parts], dim=-2))
    return rg.compose(r.unsqueeze(-1), to_bb)


def frames_to_atom14(frames: rg.Rigid, aatype: torch.Tensor) -> torch.Tensor:
    """Literature positions placed by each atom's rigid-group frame (openfold
    feats.frames_and_literature_positions_to_atom14_pos)."""
    group = table("restype_atom14_to_rigid_group", aatype)  # (..., 14)
    # each atom's frame picked by a one-hot sum over the 8 groups: exact
    # (one term is nonzero), and its backward is a sum in a fixed order where
    # torch.gather's scatter-adds the 14 atoms' gradients into 8 groups
    one_hot = torch.nn.functional.one_hot(group, frames.rots.shape[-3]).to(frames.trans.dtype)
    rots = (one_hot[..., None, None] * frames.rots[..., None, :, :, :]).sum(-3)
    trans = (one_hot[..., None] * frames.trans[..., None, :, :]).sum(-2)
    pred = rg.apply(rg.Rigid(rots, trans), table("restype_atom14_rigid_group_positions", aatype))
    return pred * table("restype_atom14_mask", aatype)[..., None]


def structure_module_apply(
    mod: StructureModule,
    cfg: StructureModuleConfig,
    s: torch.Tensor,
    z: torch.Tensor,
    aatype: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    pair=None,
) -> Dict[str, torch.Tensor]:
    """The full module (AF2 Alg. 20), fp32. ``pair``: z is this rank's rows
    (the outputs are whole on every rank). Returns per-block stacks: frames
    (K, B, L, 7), sidechain_frames (K, B, L, 8, 4, 4), unnormalized_angles and
    angles (K, B, L, 7, 2), positions (K, B, L, 14, 3), states (K, B, L, c_s),
    and single (B, L, c_s)."""
    if mask is None:
        mask = torch.ones(s.shape[:-1], dtype=s.dtype, device=s.device)
    s = layer_norm(mod.layer_norm_s, s)
    z = layer_norm(mod.layer_norm_z, z)
    s_initial = s
    s = linear(mod.linear_in, s)

    rigids = rg.identity(s.shape[:-1], s.dtype, device=s.device)
    outputs = []
    for _ in range(cfg.no_blocks):  # shared weights across blocks (AF2)
        s = s + invariant_point_attention(mod.ipa, cfg, s, z, rigids, mask, pair)
        s = layer_norm(mod.layer_norm_ipa, s)
        s = transition(mod.transition, s)
        rigids = rg.compose_q_update_vec(rigids, linear(mod.bb_update.linear, s))
        scaled = rg.scale_translation(rigids, cfg.trans_scale_factor)
        unnormalized, angles = angle_resnet(mod.angle_resnet, cfg, s, s_initial)
        all_frames = torsion_angles_to_frames(scaled, angles, aatype)
        outputs.append({
            "frames": rg.to_tensor_7(scaled),
            "sidechain_frames": rg.to_tensor_4x4(all_frames),
            "unnormalized_angles": unnormalized,
            "angles": angles,
            "positions": frames_to_atom14(all_frames, aatype),
            "states": s,
        })
        rigids = rg.stop_rot_gradient(rigids)
    out = {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}
    out["single"] = s
    return out
