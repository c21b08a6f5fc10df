"""The port's scaling model (esm_tpu_torch.parallel.scaling) against esm_tpu's
(esm_tpu/parallel/scaling.py) on the CPU.

Given esm_tpu's rates (read from esm_tpu here, never restated), the port's
plan_scaling returns esm_tpu's numbers exactly, over every documented row in
both modes; its keys name the card's terms (compute, link) where esm_tpu's
name the TPU's (MXU, ICI), and its recommendations are the same kinds. With
the card's own rates the documented warnings still fire where the model
calls a layout bad, and PERF.md carries the generated table.
"""

import dataclasses
import pathlib
import warnings

import pytest
import torch

from esm_tpu.parallel import scaling as jscaling
from esm_tpu_torch.models import esm2
from esm_tpu_torch.parallel import mesh as tmesh
from esm_tpu_torch.parallel import scaling

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"t_mxu_ms": "t_compute_ms", "t_ici_ms": "t_link_ms", "ici_bytes": "link_bytes"}
# esm_tpu's rates, and its formula's element size: it charges the gradients'
# reduce-scatter at 2 bytes, as it charges the weights' gathers
JAX_RATES = dict(gemm_tflops=jscaling.MXU_TFLOPS_MEASURED, link_gbps=jscaling.ICI_GBPS,
                 nominal_tflops=jscaling.MXU_TFLOPS_NOMINAL, grad_bytes=2)
KINDS = (("comm-bound", "link-bound"), ("no nominal-MXU headroom", "no headroom"),
         ("marginal", "marginal"))


def _kinds(recs, which):
    """Each recommendation's kind, as its index in KINDS."""
    return [next(i for i, k in enumerate(KINDS) if r.startswith(k[which])) for r in recs]


def _rows():
    for label, kw in jscaling.DOC_ROWS:
        for mode in ("inference", "train"):
            for batch in (kw["batch"], 1, 64):
                yield label, dict(kw, mode=mode, batch=batch)


@pytest.mark.parametrize("label,kw", list(_rows()), ids=lambda x: str(x)[:40])
def test_plan_scaling_matches_esm_tpu(label, kw):
    want = jscaling.plan_scaling(**kw)
    got = scaling.plan_scaling(**dict(kw, mesh_cfg=tmesh.MeshConfig(*kw["mesh_cfg"].shape)),
                               **JAX_RATES)
    renamed = {KEYS.get(k, k): v for k, v in want.items()}
    assert got.keys() == renamed.keys()
    for key, value in renamed.items():
        if key == "recommendations":
            assert _kinds(got[key], 1) == _kinds(value, 0), label
        else:
            assert got[key] == value, (label, key)


def test_accepts_a_model_config():
    cfg = esm2.ESM2Config(**esm2.ESM2_SIZES["esm2_t33_650M_UR50D"])
    by_cfg = scaling.plan_scaling(cfg, tmesh.MeshConfig(1, 1, 4), batch=8, seqlen=1024)
    by_d = scaling.plan_scaling(1280, tmesh.MeshConfig(1, 1, 4), batch=8, seqlen=1024)
    assert by_cfg == by_d
    # the fsdp gather moves the compute dtype: a bare width is bf16
    fsdp = tmesh.MeshConfig(1, 4, 1)
    gathered = lambda c: scaling.plan_scaling(c, fsdp, batch=8, seqlen=1024)[  # noqa: E731
        "weight_gather_bytes"]
    bf16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    assert gathered(cfg) == 2 * gathered(bf16) == 2 * gathered(1280) > 0


def test_warn_if_inefficient_warns_and_is_quiet():
    """esm_tpu's cases (tests/test_scaling_model.py:142) at esm_tpu's rates,
    and at the card's: ESM2-15B at B=1 on fsdp=4 x tp=2 is weight-gather
    bound on both; 3B at B=8 on tp=4 is quiet at esm_tpu's rates. ESM2-15B's
    four-card training step at the card's rates (the measured NCCL bus
    bandwidth), its fp32 gradients' reduce-scatter charged at 4 bytes, is
    link-bound at B=8 and quiet at B=16."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        scaling.warn_if_inefficient(2560, tmesh.MeshConfig(1, 1, 4), batch=8, seqlen=1024,
                                    **JAX_RATES)
        scaling.warn_if_inefficient(5120, tmesh.MeshConfig(1, 4, 1), batch=16, seqlen=1024,
                                    mode="train")
    with pytest.warns(UserWarning, match="link-bound.*weight-gather"):
        scaling.warn_if_inefficient(5120, tmesh.MeshConfig(1, 4, 1), batch=8, seqlen=1024,
                                    mode="train")
    for rates in (JAX_RATES, {}):
        with pytest.warns(UserWarning, match="weight|int8"):
            scaling.warn_if_inefficient(5120, tmesh.MeshConfig(1, 4, 2), batch=1, seqlen=1024,
                                        **rates)


def test_perf_md_carries_the_generated_table():
    assert scaling.scaling_table() in (ROOT / "PERF.md").read_text(), (
        "PERF.md's scaling table differs from the model's output: regenerate it with "
        "`python -m esm_tpu_torch.parallel.scaling`")
