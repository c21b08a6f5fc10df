"""AF2-style training losses for ESMFold, supervised by backbone coordinates.

Port of esm_tpu/models/esmfold/losses.py: batched O(L²) tensor code with no
data-dependent control flow, supervised from backbone-only ground truth (N,
CA, C per residue), which a PDB/mmCIF file gives through
``models.inverse_folding.util.load_coords``.

Terms (weights per :class:`FoldLossWeights`):
- backbone FAPE (AF2 Alg. 28 on backbone frames and CA points, clamped at
  10 Å, length scale 10 Å), averaged over every structure-module block's
  frames, as AF2 does;
- distogram cross-entropy over the trunk head's 64 bins (2.3125-21.6875 Å,
  squared-distance binning, inferred-Cβ pseudo-beta, Cα for glycine);
- pLDDT-head cross-entropy: the head's Cα channel supervised with the
  measured per-residue Cα-lDDT of the current prediction, detached (the
  head learns its model's error, it does not pull the coordinates);
- with a ``masking_pattern``, the masked-LM auxiliary on the trunk's
  ``lm_head``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ...data import residue_constants as rc
from ...ops import rigid as rg

CA_ATOM_IDX = 1  # N=0, CA=1, C=2 in both atom14 and atom37 orderings


@dataclass(frozen=True)
class FoldLossWeights:
    """Loss-term weights: AF2's weighting restricted to the terms computable
    from backbone ground truth."""

    fape: float = 1.0
    distogram: float = 0.3
    plddt: float = 0.01
    lm: float = 0.0  # used only when a masking_pattern is passed
    fape_clamp: float = 10.0
    fape_scale: float = 10.0


def _norm(v: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def backbone_frames(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor) -> rg.Rigid:
    """Ground-truth backbone frames from N/CA/C coordinates (AF2 Alg. 21):
    Gram-Schmidt with CA->C as e1, origin at CA. (..., 3) -> Rigid over (...)."""
    eps = 1e-8
    v1 = c - ca
    v2 = n - ca
    e1 = v1 / _norm(v1, eps)
    u2 = v2 - e1 * (e1 * v2).sum(-1, keepdim=True)
    e2 = u2 / _norm(u2, eps)
    e3 = torch.cross(e1, e2, dim=-1)
    return rg.Rigid(torch.stack([e1, e2, e3], dim=-1), ca)  # columns = basis vectors


def frames_from_tensor_7(t7: torch.Tensor) -> rg.Rigid:
    """The structure module's frame output (..., 7) = (quaternion wxyz,
    translation) -> Rigid."""
    return rg.Rigid(rg.quat_to_rot(t7[..., :4]), t7[..., 4:])


def fape(
    pred_frames: rg.Rigid,
    true_frames: rg.Rigid,
    frames_mask: torch.Tensor,
    pred_pts: torch.Tensor,
    true_pts: torch.Tensor,
    pts_mask: torch.Tensor,
    *,
    clamp: float = 10.0,
    length_scale: float = 10.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Frame-aligned point error (AF2 Alg. 28). ``pred_frames`` may carry
    leading dims (the structure module's blocks) beyond ``true_frames``; the
    result is averaged over them. Frames over (..., B, L), points
    (..., B, P, 3), masks (B, L) and (B, P)."""
    def expand(r):
        return rg.Rigid(r.rots[..., None, :, :], r.trans[..., None, :])

    local_pred = rg.invert_apply(expand(pred_frames), pred_pts[..., None, :, :])
    local_true = rg.invert_apply(expand(true_frames), true_pts[..., None, :, :])
    diff = local_pred - local_true  # (..., B, L, P, 3)
    d = torch.sqrt((diff * diff).sum(-1) + eps)
    d = torch.clamp(d, 0.0, clamp) / length_scale
    w = frames_mask[..., :, None] * pts_mask[..., None, :]  # (B, L, P)
    denom = torch.clamp_min(w.sum(), 1.0)
    per = (d * w).sum((-3, -2, -1)) / denom  # the leading (block) dims averaged
    return per.mean()


def pseudo_beta(aa: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The distogram's pseudo-beta from backbone coordinates (..., L, 3, 3):
    the inferred Cβ (AF2's cross-product chemistry), Cα for glycine."""
    n, ca, c = coords[..., 0, :], coords[..., 1, :], coords[..., 2, :]
    b = ca - n
    cc = c - ca
    a = torch.cross(b, cc, dim=-1)
    cb = -0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca
    is_gly = (aa == rc.restypes().index("G"))[..., None]
    return torch.where(is_gly, ca, cb)


def distogram_targets(pb: torch.Tensor, *, n_bins: int = 64, min_bin: float = 2.3125,
                      max_bin: float = 21.6875) -> torch.Tensor:
    """Bin ids (..., L, L), int64, of pseudo-beta coordinates (..., L, 3):
    AF2's squared boundaries (boundary k at linspace(min, max)[k]²; distances
    past ``max_bin`` land in the last bin)."""
    boundaries = torch.linspace(min_bin, max_bin, n_bins - 1, dtype=pb.dtype,
                                device=pb.device) ** 2
    diff = pb[..., :, None, :] - pb[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    return (d2[..., None] > boundaries).sum(-1)


def lddt_ca(pred_ca: torch.Tensor, true_ca: torch.Tensor, mask: torch.Tensor, *,
            cutoff: float = 15.0) -> torch.Tensor:
    """Per-residue superposition-free Cα-lDDT in [0, 1] (Mariani 2013), the
    batched counterpart of ``metrics.lddt(per_residue=True)``: coordinates
    (..., L, 3), mask (..., L) -> (..., L)."""
    def dist(x):
        return torch.sqrt(((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1) + 1e-10)

    dtrue, dpred = dist(true_ca), dist(pred_ca)
    L = true_ca.shape[-2]
    eye = torch.eye(L, dtype=dtrue.dtype, device=dtrue.device)
    pair = (dtrue < cutoff) * (1.0 - eye) * mask[..., :, None] * mask[..., None, :]
    diff = torch.abs(dtrue - dpred)
    kept = sum((diff < t).to(dtrue.dtype) for t in (0.5, 1.0, 2.0, 4.0)) / 4.0
    return (kept * pair).sum(-1) / torch.clamp_min(pair.sum(-1), 1.0)


def _nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target], per position."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0]


def fold_loss(
    structure: Dict[str, torch.Tensor],
    cfg,
    aa: torch.Tensor,
    mask: torch.Tensor,
    coords: torch.Tensor,
    coord_mask: torch.Tensor,
    *,
    weights: FoldLossWeights = FoldLossWeights(),
    masking_pattern: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of an ``esmfold.apply`` output. ``coords`` (B, L, 3,
    3): ground-truth N/CA/C in Å; ``coord_mask`` (B, L): 1.0 where the residue
    is resolved (combined with the padding mask). Returns (the scalar loss,
    the metrics, including the measured mean Cα-lDDT)."""
    w = coord_mask * mask.to(coords.dtype)
    true_r = backbone_frames(coords[..., 0, :], coords[..., 1, :], coords[..., 2, :])
    pred_r = frames_from_tensor_7(structure["frames"])  # (K, B, L)
    pred_ca = structure["positions"][..., CA_ATOM_IDX, :]  # (K, B, L, 3)
    true_ca = coords[..., 1, :]

    loss_fape = fape(pred_r, true_r, w, pred_ca, true_ca, w,
                     clamp=weights.fape_clamp, length_scale=weights.fape_scale)

    bins = distogram_targets(pseudo_beta(aa, coords), n_bins=cfg.distogram_bins)
    ce = _nll(structure["distogram_logits"], bins)
    pair_w = w[..., :, None] * w[..., None, :]
    loss_disto = (ce * pair_w).sum() / torch.clamp_min(pair_w.sum(), 1.0)

    # the final block's pLDDT head, Cα channel, against the measured lDDT of
    # the final prediction (detached: the head must not pull the coordinates)
    target_lddt = lddt_ca(pred_ca[-1], true_ca, w).detach()
    n_lbins = cfg.lddt_bins
    tbin = torch.clamp((target_lddt * n_lbins).long(), 0, n_lbins - 1)
    head = structure["lddt_head"][-1][..., CA_ATOM_IDX, :]  # (B, L, bins)
    ce_l = _nll(head, tbin)
    w_sum = torch.clamp_min(w.sum(), 1.0)
    loss_plddt = (ce_l * w).sum() / w_sum

    loss = weights.fape * loss_fape + weights.distogram * loss_disto + weights.plddt * loss_plddt
    metrics = {
        "fape": loss_fape,
        "distogram_ce": loss_disto,
        "plddt_ce": loss_plddt,
        "lddt_ca": (target_lddt * w).sum() / w_sum,
    }
    if masking_pattern is not None and weights.lm != 0.0:
        ce_lm = _nll(structure["lm_logits"], aa)
        w_lm = (masking_pattern == 1) * mask.to(ce_lm.dtype)
        loss_lm = (ce_lm * w_lm).sum() / torch.clamp_min(w_lm.sum(), 1.0)
        loss = loss + weights.lm * loss_lm
        metrics["lm_ce"] = loss_lm
    metrics["loss"] = loss
    return loss, metrics
