"""Evaluation metrics, numpy only.

Port of esm_tpu/metrics.py: contact precision (top-L long-range precision,
the reference's README.md:617-688 metric, computed inline in its
examples/contact_prediction.ipynb), contact maps from distance maps and
backbones, TM-score and lDDT over CA traces, and the Spearman correlation
of the zero-shot variant-effect evaluation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def contact_precision(
    predictions: np.ndarray,
    targets: np.ndarray,
    *,
    minsep: int = 24,
    maxsep: Optional[int] = None,
    topk: Optional[int] = None,
) -> float:
    """Top-k precision on an (L, L) contact map.

    predictions: (L, L) scores (e.g. ``out["contacts"]``);
    targets: (L, L) binary true-contact map (CB-CB < 8 Å);
    minsep/maxsep: the sequence-separation range (24 = "long-range");
    topk: the number of pairs scored (default L, the "@L" in precision@L).
    """
    L = predictions.shape[-1]
    if targets.shape != predictions.shape:
        raise ValueError(f"shape mismatch {predictions.shape} vs {targets.shape}")
    i, j = np.triu_indices(L, k=minsep)
    if maxsep is not None:
        keep = (j - i) < maxsep
        i, j = i[keep], j[keep]
    scores = predictions[i, j]
    true = targets[i, j].astype(np.float64)
    order = np.argsort(-scores)[: (topk if topk is not None else L)]
    return float(true[order].mean())


def contacts_from_distance_map(dist: np.ndarray, cutoff: float = 8.0) -> np.ndarray:
    """Binary contact map from a distance map (NaN = missing -> not a
    contact), the ESMStructuralSplitDataset ``dist`` field's convention."""
    with np.errstate(invalid="ignore"):
        return (np.nan_to_num(dist, nan=np.inf) < cutoff).astype(np.float32)


def inferred_cb(coords: np.ndarray) -> np.ndarray:
    """(..., L, 3, 3) N/CA/C backbone -> (..., L, 3) inferred C-beta (AF2's
    cross-product chemistry, reference esmfold trunk.py:225-243)."""
    n, ca, c = coords[..., 0, :], coords[..., 1, :], coords[..., 2, :]
    b = ca - n
    cc = c - ca
    a = np.cross(b, cc)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca


def contacts_from_backbone(coords: np.ndarray, cutoff: float = 8.0) -> np.ndarray:
    """(L, 3, 3) N/CA/C (NaN rows = missing residues) -> (L, L) binary
    CB-CB < ``cutoff`` contact map; pairs with a missing residue are 0."""
    cb = inferred_cb(coords)
    with np.errstate(invalid="ignore"):
        d = np.linalg.norm(cb[:, None, :] - cb[None, :, :], axis=-1)
    return contacts_from_distance_map(d, cutoff)


def kabsch_superimpose(fixed: np.ndarray, mobile: np.ndarray) -> np.ndarray:
    """``mobile`` (N, 3) moved onto ``fixed`` (N, 3) by the RMSD-optimal
    rotation and translation (the port's copy of
    esm_tpu/apps/ppl/geometry.py:56)."""
    cf = fixed.mean(0)
    cm = mobile.mean(0)
    h = (mobile - cm).T @ (fixed - cf)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return (mobile - cm) @ r.T + cf


def _ca_pair(coords_ref, coords_model):
    ref = np.asarray(coords_ref, np.float64)
    mod = np.asarray(coords_model, np.float64)
    if ref.shape != mod.shape or ref.ndim != 2 or ref.shape[1] != 3:
        raise ValueError(f"CA traces of shape (L, 3) expected, got {ref.shape} and {mod.shape}")
    return ref, mod


def tm_score(coords_ref: np.ndarray, coords_model: np.ndarray, *,
             superimpose: bool = True) -> float:
    """TM-score of CA traces (Zhang & Skolnick 2004): (1/L) sum 1/(1 +
    (d_i/d0)^2), d0 = 1.24 (L - 15)^(1/3) - 1.8 (at least 0.5). With
    ``superimpose`` the model is Kabsch-aligned to the reference first (the
    RMSD-optimal frame: exact for good models, a lower bound of TM-align's
    search otherwise). coords: (L, 3)."""
    ref, mod = _ca_pair(coords_ref, coords_model)
    L = ref.shape[0]
    if superimpose:
        mod = kabsch_superimpose(ref, mod)
    d = np.linalg.norm(ref - mod, axis=-1)
    d0 = max(1.24 * max(L - 15, 1) ** (1.0 / 3.0) - 1.8, 0.5)
    return float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))


def lddt(coords_ref: np.ndarray, coords_model: np.ndarray, *, cutoff: float = 15.0,
         thresholds: tuple = (0.5, 1.0, 2.0, 4.0), per_residue: bool = False):
    """Superposition-free lDDT over CA distances (Mariani et al. 2013): for
    every pair within ``cutoff`` in the reference, the share of model
    distances kept within each threshold, averaged over the thresholds: the
    measured counterpart of ESMFold's pLDDT head. coords: (L, 3)."""
    ref, mod = _ca_pair(coords_ref, coords_model)
    dref = np.linalg.norm(ref[:, None] - ref[None, :], axis=-1)
    dmod = np.linalg.norm(mod[:, None] - mod[None, :], axis=-1)
    L = ref.shape[0]
    pair = (dref < cutoff) & ~np.eye(L, dtype=bool)
    diff = np.abs(dref - dmod)
    kept = sum((diff < t).astype(np.float64) for t in thresholds) / len(thresholds)
    if per_residue:
        return (kept * pair).sum(-1) / np.maximum(pair.sum(-1), 1)
    return float((kept * pair).sum() / max(pair.sum(), 1))


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties sharing their average rank."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1)
    # average the rank over each group of equal values
    sorted_x = x[order]
    group_start = np.concatenate([[True], sorted_x[1:] != sorted_x[:-1]])
    group_id = np.cumsum(group_start) - 1
    sums = np.bincount(group_id, weights=ranks[order])
    counts = np.bincount(group_id)
    ranks[order] = (sums / counts)[group_id]
    return ranks


def spearman(x, y) -> float:
    """Spearman rank correlation (average-tie ranks), NaN pairs dropped.

    The headline metric of the reference's zero-shot variant-effect
    evaluation (examples/variant-prediction/README.md: |rho| per protein
    between model scores and DMS measurements)."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"length mismatch {x.shape} vs {y.shape}")
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    if len(x) < 2:
        raise ValueError("need at least 2 finite pairs")
    rx, ry = _average_ranks(x), _average_ranks(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    if denom == 0:
        return float("nan")
    return float((rx * ry).sum() / denom)
