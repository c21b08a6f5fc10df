"""Evaluation metrics, numpy only.

Port of esm_tpu/metrics.py. Only ``spearman`` is here so far: the zero-shot
variant-effect score (``cli/predict_variants.py --eval-column``). The
contact, lDDT and TM-score metrics come with the fold trainer (ROADMAP Queue
1, item 10).
"""

from __future__ import annotations

import numpy as np


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
