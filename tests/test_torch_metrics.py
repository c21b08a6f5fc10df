"""The port's numpy metrics (esm_tpu_torch.metrics) against esm_tpu.metrics
on seeded inputs: contact precision, contact maps from distance maps and
backbones, the inferred C-beta, TM-score (with and without the Kabsch
superposition, whose copy is held to esm_tpu.apps.ppl.geometry's), lDDT
and Spearman's rho. Both are float64 numpy with the same operations: the
results agree to 1e-12.
"""

import numpy as np
import pytest

from esm_tpu import metrics as jm
from esm_tpu.apps.ppl.geometry import kabsch_superimpose as j_kabsch
from esm_tpu_torch import metrics as tm

TOL = dict(atol=1e-12, rtol=0)


def _trace(seed, n=40):
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(n, 3) * 2.0, axis=0)


def _backbone(seed, n=30):
    rng = np.random.RandomState(seed)
    ca = _trace(seed, n)
    return np.stack([ca + rng.randn(n, 3) * 0.5 + [-1.2, 0.6, 0.0], ca,
                     ca + rng.randn(n, 3) * 0.5 + [1.3, -0.6, 0.2]], axis=1)


@pytest.mark.parametrize("kw", [{}, {"minsep": 6}, {"minsep": 6, "maxsep": 12},
                                {"minsep": 12, "topk": 5}])
def test_contact_precision_matches(kw):
    rng = np.random.RandomState(0)
    L = 50
    pred = rng.rand(L, L)
    true = (rng.rand(L, L) < 0.1).astype(np.float32)
    assert tm.contact_precision(pred, true, **kw) == jm.contact_precision(pred, true, **kw)
    with pytest.raises(ValueError):
        tm.contact_precision(pred, true[:-1, :-1])


def test_contact_maps_and_cb_match():
    coords = _backbone(1)
    coords[4] = np.nan  # a missing residue
    np.testing.assert_allclose(tm.inferred_cb(coords), jm.inferred_cb(coords), **TOL)
    np.testing.assert_array_equal(tm.contacts_from_backbone(coords),
                                  jm.contacts_from_backbone(coords))
    assert tm.contacts_from_backbone(coords)[4].sum() == 0
    dist = np.random.RandomState(2).rand(20, 20) * 16
    dist[3, 5] = np.nan
    for cutoff in (8.0, 6.0):
        np.testing.assert_array_equal(tm.contacts_from_distance_map(dist, cutoff),
                                      jm.contacts_from_distance_map(dist, cutoff))


@pytest.mark.parametrize("superimpose", [True, False])
def test_tm_score_matches(superimpose):
    ref = _trace(3)
    rng = np.random.RandomState(4)
    q = np.linalg.qr(rng.randn(3, 3))[0]
    model = (ref + rng.randn(*ref.shape) * 1.5) @ q.T + 7.0
    got = tm.tm_score(ref, model, superimpose=superimpose)
    assert abs(got - jm.tm_score(ref, model, superimpose=superimpose)) <= 1e-12
    assert abs(tm.tm_score(ref, ref @ q.T + 3.0) - 1.0) <= 1e-9  # a rigid copy scores 1
    np.testing.assert_allclose(tm.kabsch_superimpose(ref, model), j_kabsch(ref, model), **TOL)
    with pytest.raises(ValueError):
        tm.tm_score(ref, model[:-1])


@pytest.mark.parametrize("per_residue", [False, True])
def test_lddt_matches(per_residue):
    ref = _trace(5)
    model = ref + np.random.RandomState(6).randn(*ref.shape) * 0.8
    for kw in ({}, {"cutoff": 10.0, "thresholds": (1.0, 2.0)}):
        np.testing.assert_allclose(tm.lddt(ref, model, per_residue=per_residue, **kw),
                                   jm.lddt(ref, model, per_residue=per_residue, **kw), **TOL)


def test_spearman_matches():
    rng = np.random.RandomState(7)
    x = rng.randint(0, 10, 60).astype(float)  # ties
    y = x + rng.randn(60)
    y[3] = np.nan
    assert tm.spearman(x, y) == jm.spearman(x, y)
