"""Plain ESMFold in float32: the yardstick the benchmark holds the port's fold to.

A frozen copy of the port's plain fold at one device (its ``models/esmfold``,
``ops/triangle.py``, ``ops/rigid.py`` and residue constants, as of the
benchmark's first version), with every kernel branch, every sharded branch
and every lower-precision option taken out: exact triangle attention, the
unfused triangle multiplication, float32 throughout, the LM through
``reference/esm2.py``. It runs on a flat state dict in the reference
checkpoint's layout (``esm.*`` for the LM, ``trunk.blocks.{i}.*``, ...), the
one the benchmark draws and loads into the program. It imports nothing of
the program; ``residue_constants.npz`` beside it is a byte copy of the
port's table file (AlphaFold's published literature geometry).

Semantics: Lin et al., Science 2023 (facebookresearch/esm
``esm/esmfold/v1``) and openfold's modules it uses (AF2 Algorithms 11-14,
20-23).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from . import esm2

W = Dict[str, torch.Tensor]


@functools.lru_cache(None)
def _constants() -> dict:
    path = os.path.join(os.path.dirname(__file__), "residue_constants.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _table(name: str, aatype: torch.Tensor) -> torch.Tensor:
    a = np.asarray(_constants()[name])
    t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
    return t.to(aatype.device)[aatype]


def encode(seq: str) -> torch.Tensor:
    """AF2 residue indices of a single chain (X for an unknown letter)."""
    order = {str(r): i for i, r in enumerate(_constants()["restypes_with_x"])}
    return torch.tensor([order.get(a, order["X"]) for a in seq], dtype=torch.int64)


# -- small pieces -----------------------------------------------------------

def lin(w: W, name: str, x: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    y = mm(x, w[f"{name}.weight"].t())
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def ln(w: W, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                                          w[f"{name}.bias"], eps)


def mlp(w: W, name: str, x: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """LayerNorm, Linear, ReLU, Linear (keys .0, .1, .3)."""
    return lin(w, f"{name}.3", torch.relu(lin(w, f"{name}.1", ln(w, f"{name}.0", x), mm)), mm)


# -- rigid transforms (openfold's Rigid, rotation matrices) -------------------

class Rigid(NamedTuple):
    rots: torch.Tensor   # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)

    def unsqueeze(self, dim: int) -> "Rigid":
        d = dim if dim >= 0 else self.trans.dim() + dim
        return Rigid(self.rots.unsqueeze(d), self.trans.unsqueeze(d))


def _matvec(m, v):
    return (m * v[..., None, :]).sum(-1)


def _matmul3(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def r_apply(r: Rigid, pts):
    return _matvec(r.rots, pts) + r.trans


def r_invert_apply(r: Rigid, pts):
    return _matvec(r.rots.transpose(-1, -2), pts - r.trans)


def r_compose(a: Rigid, b: Rigid) -> Rigid:
    return Rigid(_matmul3(a.rots, b.rots), _matvec(a.rots, b.trans) + a.trans)


def quat_to_rot(q):
    w_, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2.0 * (y * y + z * z), 2.0 * (x * y - z * w_), 2.0 * (x * z + y * w_),
        2.0 * (x * y + z * w_), 1 - 2.0 * (x * x + z * z), 2.0 * (y * z - x * w_),
        2.0 * (x * z - y * w_), 2.0 * (y * z + x * w_), 1 - 2.0 * (x * x + y * y)], dim=-1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def compose_q_update_vec(r: Rigid, update) -> Rigid:
    """AF2 Alg. 23: (b, c, d, tx, ty, tz) -> quaternion (1, b, c, d) composed
    on the right, the translation applied in the current frame."""
    q_vec, t_vec = update[..., :3], update[..., 3:]
    quat = torch.cat([torch.ones_like(q_vec[..., :1]), q_vec], dim=-1)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return Rigid(_matmul3(r.rots, quat_to_rot(quat)), _matvec(r.rots, t_vec) + r.trans)


# -- the trunk ----------------------------------------------------------------

def relative_position(w: W, residx, mask, bins: int):
    diff = residx[:, None, :] - residx[:, :, None]
    diff = diff.clamp(-bins, bins) + bins + 1
    pair_mask = mask[:, None, :] * mask[:, :, None]
    diff = torch.where(pair_mask.bool(), diff, torch.zeros_like(diff))
    return w["trunk.pairwise_positional_embedding.embedding.weight"][diff]


def gated_attention(w: W, name: str, x, heads: int, mask, bias, mm):
    b, l, c = x.shape
    hw = c // heads
    t = lin(w, f"{name}.proj", x, mm).reshape(b, l, heads, 3 * hw).transpose(1, 2)
    q, k, v = t.chunk(3, dim=-1)
    a = mm(q * hw ** -0.5, k.transpose(-1, -2)) + bias.permute(0, 3, 1, 2)
    a = torch.where(mask[:, None, None, :].bool(), a, float("-inf"))
    y = mm(torch.softmax(a, dim=-1), v).transpose(1, 2).reshape(b, l, c)
    y = torch.sigmoid(lin(w, f"{name}.g_proj", x, mm)) * y
    return lin(w, f"{name}.o_proj", y, mm)


def sequence_to_pair(w: W, name: str, s, mm):
    s = lin(w, f"{name}.proj", ln(w, f"{name}.layernorm", s), mm)
    q, k = s.chunk(2, dim=-1)
    prod = q[:, None, :, :] * k[:, :, None, :]
    diff = q[:, None, :, :] - k[:, :, None, :]
    return lin(w, f"{name}.o_proj", torch.cat([prod, diff], dim=-1), mm)


def triangle_multiplication(w: W, name: str, z, outgoing: bool, mask, mm):
    mask = mask[..., None]
    zn = ln(w, f"{name}.layer_norm_in", z)
    a = mask * torch.sigmoid(lin(w, f"{name}.linear_a_g", zn, mm)) * lin(
        w, f"{name}.linear_a_p", zn, mm)
    b = mask * torch.sigmoid(lin(w, f"{name}.linear_b_g", zn, mm)) * lin(
        w, f"{name}.linear_b_p", zn, mm)
    if outgoing:  # x[i, j] = sum_k a[i, k] b[j, k], a product per channel
        x = mm(a.permute(0, 3, 1, 2), b.permute(0, 3, 2, 1))
    else:         # x[i, j] = sum_k a[k, i] b[k, j]
        x = mm(a.permute(0, 3, 2, 1), b.permute(0, 3, 1, 2))
    x = lin(w, f"{name}.linear_z", ln(w, f"{name}.layer_norm_out", x.permute(0, 2, 3, 1)), mm)
    return x * torch.sigmoid(lin(w, f"{name}.linear_g", zn, mm))


def triangle_attention(w: W, name: str, z, heads: int, starting: bool, mask, mm, inf=1e9):
    if not starting:
        z, mask = z.transpose(-2, -3), mask.transpose(-1, -2)
    zn = ln(w, f"{name}.layer_norm", z)
    tri = lin(w, f"{name}.linear", zn, mm)  # (B, I, J, H)
    b, i, j, c = zn.shape
    hd = c // heads

    def split(t):
        return t.reshape(b, i, j, heads, hd).transpose(2, 3)  # (B, I, H, J, hd)

    q = split(lin(w, f"{name}.mha.linear_q", zn, mm)) / math.sqrt(hd)
    k = split(lin(w, f"{name}.mha.linear_k", zn, mm))
    v = split(lin(w, f"{name}.mha.linear_v", zn, mm))
    a = mm(q, k.transpose(-1, -2))
    a = a + (inf * (mask - 1.0))[..., :, None, None, :] + tri.permute(0, 3, 1, 2)[:, None]
    o = mm(torch.softmax(a, dim=-1), v).transpose(2, 3).reshape(b, i, j, c)
    o = lin(w, f"{name}.mha.linear_o", o * torch.sigmoid(lin(w, f"{name}.mha.linear_g", zn, mm)),
            mm)
    return o.transpose(-2, -3) if not starting else o


def trunk_block(w: W, name: str, s, z, mask, seq_heads: int, pair_heads: int, mm):
    bias = lin(w, f"{name}.pair_to_sequence.linear",
               ln(w, f"{name}.pair_to_sequence.layernorm", z), mm)
    y = gated_attention(w, f"{name}.seq_attention", ln(w, f"{name}.layernorm_1", s),
                        seq_heads, mask, bias, mm)
    s = s + y
    s = s + mlp(w, f"{name}.mlp_seq.mlp", s, mm)
    z = z + sequence_to_pair(w, f"{name}.sequence_to_pair", s, mm)
    tri_mask = mask[:, :, None] * mask[:, None, :]
    z = z + triangle_multiplication(w, f"{name}.tri_mul_out", z, True, tri_mask, mm)
    z = z + triangle_multiplication(w, f"{name}.tri_mul_in", z, False, tri_mask, mm)
    z = z + triangle_attention(w, f"{name}.tri_att_start", z, pair_heads, True, tri_mask, mm)
    z = z + triangle_attention(w, f"{name}.tri_att_end", z, pair_heads, False, tri_mask, mm)
    return s, z + mlp(w, f"{name}.mlp_pair.mlp", z, mm)


def distogram_bins(coords, min_bin=3.375, max_bin=21.375, num_bins=15):
    boundaries = torch.linspace(min_bin, max_bin, num_bins - 1, device=coords.device) ** 2
    n, ca, c = coords[..., 0, :], coords[..., 1, :], coords[..., 2, :]
    b = ca - n
    c_ = c - ca
    a = torch.cross(b, c_, dim=-1)
    cb = -0.58273431 * a + 0.56802827 * b - 0.54067466 * c_ + ca
    d2 = ((cb[..., None, :, :] - cb[..., :, None, :]) ** 2).sum(-1, keepdim=True)
    return (d2 > boundaries).sum(-1)


# -- the structure module ----------------------------------------------------

def invariant_point_attention(w: W, sm: dict, s, z, r: Rigid, mask):
    name = "trunk.structure_module.ipa"
    b, l, _ = s.shape
    h, c, pq, pv = sm["no_heads_ipa"], sm["c_ipa"], sm["no_qk_points"], sm["no_v_points"]

    def points(t, n):
        xyz = torch.stack(t.chunk(3, dim=-1), dim=-1)
        return r_apply(r.unsqueeze(-1), xyz).reshape(b, l, h, n, 3)

    q = lin(w, f"{name}.linear_q", s).reshape(b, l, h, c)
    k, v = lin(w, f"{name}.linear_kv", s).reshape(b, l, h, 2 * c).split(c, dim=-1)
    q_pts = points(lin(w, f"{name}.linear_q_points", s), pq)
    k_pts, v_pts = points(lin(w, f"{name}.linear_kv_points", s), pq + pv).split([pq, pv], dim=-2)
    bias = lin(w, f"{name}.linear_b", z)
    a = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * math.sqrt(1.0 / (3 * c))
    a = a + math.sqrt(1.0 / 3) * bias.permute(0, 3, 1, 2)
    head_w = torch.nn.functional.softplus(w[f"{name}.head_weights"]) * math.sqrt(
        1.0 / (3 * (pq * 9.0 / 2)))
    d2 = ((q_pts[:, :, None] - k_pts[:, None, :]) ** 2).sum((-1, -2))  # (B, Li, Lj, H)
    a = a + d2.permute(0, 3, 1, 2) * (head_w[None, :, None, None] * -0.5)
    a = a + (sm["inf"] * (mask[:, :, None] * mask[:, None, :] - 1.0))[:, None]
    a = torch.softmax(a, dim=-1)
    o = torch.matmul(a, v.transpose(1, 2)).transpose(1, 2).reshape(b, l, h * c)
    o_pt = torch.matmul(a, v_pts.reshape(b, l, h, pv * 3).transpose(1, 2))
    o_pt = o_pt.reshape(b, h, l, pv, 3).permute(0, 2, 1, 3, 4)
    o_pt = r_invert_apply(r.unsqueeze(-1).unsqueeze(-1), o_pt)
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + sm["epsilon"]).reshape(b, l, h * pv)
    o_pt_flat = o_pt.reshape(b, l, h * pv, 3)
    o_pair = torch.matmul(a.transpose(1, 2), z).reshape(b, l, h * z.shape[-1])
    cat = torch.cat([o, o_pt_flat[..., 0], o_pt_flat[..., 1], o_pt_flat[..., 2], o_pt_norm,
                     o_pair], dim=-1)
    return lin(w, f"{name}.linear_out", cat)


def angle_resnet(w: W, sm: dict, s, s_initial):
    name = "trunk.structure_module.angle_resnet"
    s = lin(w, f"{name}.linear_in", torch.relu(s)) + lin(w, f"{name}.linear_initial",
                                                          torch.relu(s_initial))
    for i in range(sm["no_resnet_blocks"]):
        s = s + lin(w, f"{name}.layers.{i}.linear_2",
                    torch.relu(lin(w, f"{name}.layers.{i}.linear_1", torch.relu(s))))
    s = lin(w, f"{name}.linear_out", torch.relu(s))
    s = s.reshape(s.shape[:-1] + (sm["no_angles"], 2))
    return s / torch.sqrt(torch.clamp_min((s ** 2).sum(-1, keepdim=True), sm["epsilon"]))


def torsion_angles_to_frames(r: Rigid, alpha, aatype) -> Rigid:
    t4 = _table("restype_rigid_group_default_frame", aatype)
    default_r = Rigid(t4[..., :3, :3], t4[..., :3, 3])
    bb_rot = torch.zeros(alpha.shape[:-2] + (1, 2), dtype=alpha.dtype, device=alpha.device)
    bb_rot[..., 1] = 1.0
    alpha = torch.cat([bb_rot, alpha], dim=-2)
    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros, ones = torch.zeros_like(sin_a), torch.ones_like(sin_a)
    rots = torch.stack([ones, zeros, zeros, zeros, cos_a, -sin_a, zeros, sin_a, cos_a],
                       dim=-1).reshape(sin_a.shape + (3, 3))
    frames = r_compose(default_r, Rigid(rots, torch.zeros_like(default_r.trans)))

    def at(i):
        return Rigid(frames.rots[..., i, :, :], frames.trans[..., i, :])

    chi2 = r_compose(at(4), at(5))
    chi3 = r_compose(chi2, at(6))
    chi4 = r_compose(chi3, at(7))
    parts = [Rigid(frames.rots[..., :5, :, :], frames.trans[..., :5, :])] + [
        c.unsqueeze(-1) for c in (chi2, chi3, chi4)]
    to_bb = Rigid(torch.cat([p.rots for p in parts], dim=-3),
                  torch.cat([p.trans for p in parts], dim=-2))
    return r_compose(r.unsqueeze(-1), to_bb)


def frames_to_atom14(frames: Rigid, aatype):
    group = _table("restype_atom14_to_rigid_group", aatype)
    one_hot = torch.nn.functional.one_hot(group, frames.rots.shape[-3]).to(frames.trans.dtype)
    rots = (one_hot[..., None, None] * frames.rots[..., None, :, :, :]).sum(-3)
    trans = (one_hot[..., None] * frames.trans[..., None, :, :]).sum(-2)
    pred = r_apply(Rigid(rots, trans), _table("restype_atom14_rigid_group_positions", aatype))
    return pred * _table("restype_atom14_mask", aatype)[..., None]


def structure_module(w: W, sm: dict, s, z, aatype, mask):
    name = "trunk.structure_module"
    s = ln(w, f"{name}.layer_norm_s", s)
    z = ln(w, f"{name}.layer_norm_z", z)
    s_initial = s
    s = lin(w, f"{name}.linear_in", s)
    b, l = s.shape[:2]
    r = Rigid(torch.eye(3, device=s.device).expand(b, l, 3, 3),
              torch.zeros(b, l, 3, device=s.device))
    for _ in range(sm["no_blocks"]):
        s = s + invariant_point_attention(w, sm, s, z, r, mask)
        s = ln(w, f"{name}.layer_norm_ipa", s)
        for i in range(sm["no_transition_layers"]):
            t = f"{name}.transition.layers.{i}"
            s = s + lin(w, f"{t}.linear_3", torch.relu(
                lin(w, f"{t}.linear_2", torch.relu(lin(w, f"{t}.linear_1", s)))))
        s = ln(w, f"{name}.transition.layer_norm", s)
        r = compose_q_update_vec(r, lin(w, f"{name}.bb_update.linear", s))
        scaled = Rigid(r.rots, r.trans * sm["trans_scale_factor"])
        angles = angle_resnet(w, sm, s, s_initial)
        positions = frames_to_atom14(torsion_angles_to_frames(scaled, angles, aatype), aatype)
    return {"positions": positions, "states": s}


# -- the whole fold ------------------------------------------------------------

def fold(w: W, cfg: dict, seqs: Sequence[str], mm=torch.matmul,
         sm_tf32: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Each sequence (one chain, one at a time) folded with ``cfg``'s passes:
    [{"positions": (L, 14, 3), "plddt": (L, 37), "ptm": (), "mean_plddt": (),
    "s_s": (L, c_s), "s_z": (L, L, c_z)}], the last two the trunk's output.
    ``mm`` is the LM's and the trunk's matrix product (``esm2.fp8_matmul`` for
    the lower-precision control); the structure module and the heads run in
    float32, or with ``sm_tf32`` (the control's) their products in TF32."""
    return [_fold_one(w, cfg, s, mm, sm_tf32) for s in seqs]


def structure(w: W, cfg: dict, s_s, s_z, seq: str, tf32: bool = False):
    """The structure module and the heads on the trunk's output of one chain
    (s_s (L, c_s), s_z (L, L, c_z)): {"positions", "plddt", "ptm",
    "mean_plddt"} as :func:`fold` gives them."""
    device = s_s.device
    aa = encode(seq).to(device)[None]
    mask = torch.ones(aa.shape, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        s_s, s_z = s_s[None], s_z[None]
        out = structure_module(w, cfg["structure_module"], lin(w, "trunk.trunk2sm_s", s_s),
                               lin(w, "trunk.trunk2sm_z", s_z), aa, mask)
        h = ln(w, "lddt_head.0", out["states"])
        for i in (1, 2, 3):
            h = lin(w, f"lddt_head.{i}", h)
        lddt = h.reshape(aa.shape + (37, cfg["lddt_bins"]))
        edges = torch.linspace(0.0, 1.0, cfg["lddt_bins"] + 1, device=device)
        plddt = 100 * (torch.softmax(lddt, dim=-1) * ((edges[:-1] + edges[1:]) / 2)).sum(-1)
        ptm = _ptm(lin(w, "ptm_head", s_z), cfg["distogram_bins"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    exists = _table("restype_atom37_mask", aa)
    return {"positions": out["positions"][0], "plddt": plddt[0], "ptm": ptm[0],
            "mean_plddt": (plddt * exists).sum() / exists.sum()}


def _fold_one(w: W, cfg: dict, seq: str, mm, sm_tf32: bool):
    tc, sm, lm = cfg["trunk"], cfg["structure_module"], cfg["esm"]
    device = w["embedding.weight"].device
    aa = encode(seq).to(device)[None]
    b, l = aa.shape
    mask = torch.ones(b, l, device=device)
    residx = torch.arange(l, device=device)[None]
    # AF2 index -> ESM token: 0 is padding, 1..21 the residues with X
    order = [str(r) for r in _constants()["restypes_with_x"]]
    to_esm = torch.tensor([esm2.PAD] + [esm2.IDX[r] for r in order], device=device)
    esmaa = torch.cat([torch.full((b, 1), esm2.CLS, device=device), to_esm[aa + 1],
                       torch.full((b, 1), esm2.EOS, device=device)], dim=1)
    lm_w = {k[4:]: v for k, v in w.items() if k.startswith("esm.")}
    hid = esm2.forward(lm_w, lm, esmaa, mm=mm, hiddens=True)["hiddens"]
    combine = torch.softmax(w["esm_s_combine"], dim=0)
    esm_s = sum(c * h for c, h in zip(combine, hid))[:, 1:l + 1]
    s_s_0 = mlp(w, "esm_s_mlp", esm_s, mm) + w["embedding.weight"][aa]
    s_z_0 = s_s_0.new_zeros((b, l, l, tc["pairwise_state_dim"]))

    seq_heads = tc["sequence_state_dim"] // tc["sequence_head_width"]
    pair_heads = tc["pairwise_state_dim"] // tc["pairwise_head_width"]
    s_s = torch.zeros_like(s_s_0)
    s_z = torch.zeros_like(s_z_0)
    bins = torch.zeros(s_z_0.shape[:-1], dtype=torch.int64, device=device)
    passes = tc["max_recycles"]  # the port's infer default: that many passes
    for p in range(passes):
        s = s_s_0 + ln(w, "trunk.recycle_s_norm", s_s)
        z = s_z_0 + ln(w, "trunk.recycle_z_norm", s_z) + w["trunk.recycle_disto.weight"][bins]
        z = z + relative_position(w, residx, mask, tc["position_bins"])
        for i in range(tc["num_blocks"]):
            s, z = trunk_block(w, f"trunk.blocks.{i}", s, z, mask, seq_heads, pair_heads, mm)
        s_s, s_z = s, z
        out = structure(w, cfg, s_s[0], s_z[0], seq, sm_tf32)
        if p + 1 < passes:
            bins = distogram_bins(out["positions"][None, :, :3])
    return dict(out, s_s=s_s[0], s_z=s_z[0])


def _ptm(logits, no_bins: int, max_bin: int = 31):
    """Predicted TM-score of a single chain with every residue real."""
    boundaries = torch.linspace(0.0, max_bin, no_bins - 1, device=logits.device)
    step = boundaries[1] - boundaries[0]
    centers = torch.cat([boundaries + step / 2, (boundaries[-1] + 3 * step / 2)[None]])
    n = logits.shape[-2]
    d0 = 1.24 * (max(n, 19) - 15) ** (1.0 / 3) - 1.8
    tm = (torch.softmax(logits, dim=-1) * (1.0 / (1 + centers ** 2 / d0 ** 2))).sum(-1)
    return tm.mean(-1).amax(-1)
