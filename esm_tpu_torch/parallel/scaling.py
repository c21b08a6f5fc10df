"""Analytic compute-vs-link scaling model for choosing a mesh on H100s.

Port of esm_tpu/parallel/scaling.py (:50-157, :282-320, :368-383) with the
card's rates. Per rank, per ESM-2 layer, at batch B, length T, width d:

  compute  dense GEMMs 24 B T d^2 plus attention 4 B T_q T d FLOPs, divided
           by tp (Megatron splits heads and MLP) and by the batch split
           B_local = ceil(B / (data x fsdp));
  link     tp: two all-reduces of the (B_local, T, d) bf16 activation per
           layer = 8 (tp - 1)/tp B_local T d bytes;
           fsdp: ZeRO-3's weight gather (fsdp - 1)/fsdp 12 d^2 elements of
           the compute dtype (and in a training step the recompute's
           gather and the gradients' reduce-scatter at grad_bytes);
           ring (sequence parallel): the key/value pair goes round the
           whole ring, 4 (ring - 1)/ring B_local T d bytes.

r = t_link / t_compute decides: with the collectives overlapped the
efficiency is about min(1, 1/r); run one after the other, 1/(1 + r). The
port issues its collectives in order with the compute (no overlap yet), so
``efficiency_serial`` is the one that applies to it today. ``r_nominal``
re-evaluates at the card's published bf16 rate, so a layout that hides its
traffic only behind slow GEMMs is flagged.

The tp/fsdp byte counts follow the port's collectives:
``parallel/tensor_parallel.py`` all-reduces the bf16 activation twice a
layer (after out_proj and fc2) and gathers each layer's weights once a
forward, cast to the compute dtype before the gather (a config's
``compute_dtype``; bf16's 2 bytes for a bare width), fp32 masters or bf16
shards alike. A training step gathers them
again in the remat recompute and reduce-scatters their gradients in the
masters' dtype (4 bytes for fp32 masters). esm_tpu charges all three
moves at 2 bytes: ``grad_bytes=2`` gives its formula.

``plan_scaling_fold`` waits for the sharded fold (ROADMAP Queue 1, item 13c).
The table, :func:`scaling_table`, is in PERF.md (generated; a test holds
the two equal).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List

from .mesh import MeshConfig

# The bf16 GEMM rate the card reached at ESM2-650M's layer products (q, k,
# v, out, fc1, fc2 over 8 x 1024 tokens, F.linear): chip_smoke.py [shard],
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6, PR 15).
GEMM_TFLOPS_MEASURED = 712.3
# The H100 SXM's published dense bf16 rate (NVIDIA's data sheet; 700 W).
GEMM_TFLOPS_NOMINAL = 989.0
# NVLink 4 on an H100 SXM: 900 GB/s a card, both directions together, so
# 450 GB/s each way (NVIDIA's data sheet). Nominal: no four-card call has
# measured a NCCL all-reduce yet.
LINK_GBPS = 450.0


def _width(cfg) -> int:
    return cfg if isinstance(cfg, int) else cfg.embed_dim


def _compute_bytes(cfg) -> int:
    """Bytes of an element of the compute dtype: what a gathered weight
    moves (bf16 for a bare width)."""
    return 2 if isinstance(cfg, int) else cfg.compute_dtype.itemsize


def plan_scaling(
    cfg,
    mesh_cfg: MeshConfig,
    batch: int,
    seqlen: int,
    *,
    mode: str = "inference",
    ring: int = 1,
    gemm_tflops: float = GEMM_TFLOPS_MEASURED,
    link_gbps: float = LINK_GBPS,
    nominal_tflops: float = GEMM_TFLOPS_NOMINAL,
    grad_bytes: float = 4.0,
) -> Dict:
    """Per-rank, per-layer compute time, link bytes, r, r_nominal and the
    predicted scaling efficiency of an ESM-2 on a mesh (esm_tpu :50).

    cfg: an ESM2Config (uses .embed_dim) or the width ``d``.
    mode: "inference" or "train": training triples the FLOPs (forward and
        backward), doubles the tp all-reduces (their backward) and makes
        each ZeRO gather a gather, a recompute's gather and a gradient
        reduce-scatter (x3).
    ring: sequence-parallel shards, in addition to the mesh's axes (pass
        MeshConfig(1, 1, 1) with ring=N for pure sequence parallelism).
    grad_bytes: bytes an element of a reduce-scattered gradient moves (the
        masters' dtype's: 4 for the port's fp32 masters, 2 for esm_tpu's
        formula).

    Returns t_compute_ms, t_link_ms, the byte breakdown, r, r_nominal,
    efficiency_overlapped = min(1, 1/r), efficiency_serial = 1/(1 + r),
    and ``recommendations``: warnings, empty when the layout is predicted to
    clear 90% with headroom at the published rate."""
    if mode not in ("inference", "train"):
        raise ValueError(f"mode must be 'inference' or 'train', got {mode!r}")
    d = _width(cfg)
    weight_bytes = _compute_bytes(cfg)
    tp, fsdp, ring = mesh_cfg.tp, mesh_cfg.fsdp, max(ring, 1)
    b_local = -(-batch // max(mesh_cfg.data * fsdp, 1))
    t_local = -(-seqlen // ring)

    flops_mult = 3.0 if mode == "train" else 1.0
    gemm_flops = 24.0 * b_local * t_local * d * d / tp
    attn_flops = 4.0 * b_local * t_local * seqlen * d / tp
    t_compute = flops_mult * (gemm_flops + attn_flops) / (gemm_tflops * 1e12)
    t_compute_nominal = flops_mult * (gemm_flops + attn_flops) / (nominal_tflops * 1e12)

    ar_mult = 2.0 if mode == "train" else 1.0
    # bytes per weight over a step: the gather (and in training the
    # recompute's gather and the gradients' reduce-scatter)
    zero_bytes = 2.0 * weight_bytes + grad_bytes if mode == "train" else weight_bytes
    allreduce = ar_mult * 8.0 * (tp - 1) / tp * b_local * t_local * d
    weight_gather = (fsdp - 1) / fsdp * 12.0 * d * d * zero_bytes
    ring_bytes = 4.0 * (ring - 1) / ring * b_local * seqlen * d
    link_bytes = allreduce + weight_gather + ring_bytes
    t_link = link_bytes / (link_gbps * 1e9)

    r = t_link / t_compute if t_compute > 0 else math.inf
    r_nominal = t_link / t_compute_nominal if t_compute_nominal > 0 else math.inf

    if weight_gather > 0.5 * link_bytes:
        dominant, remedy = "ZeRO weight-gather", (
            f"raise the batch to amortize the gathers (B={batch} now), or drop the fsdp "
            "axis for a weight-only int8 model on fewer cards (esm_tpu_torch.quantization; "
            "ESM2-15B in int8 fits one 80 GB card)")
    elif allreduce > 0.5 * link_bytes:
        dominant, remedy = f"tp={tp} all-reduce", (
            f"use tp={max(tp // 2, 1)} or data-parallel replicas: this width is past its "
            "useful tensor parallelism")
    else:
        dominant, remedy = "KV-ring", "use fewer, longer sequence shards"

    recs: List[str] = []
    if r >= 1.0:
        recs.append(f"link-bound (r={r:.2f}): {dominant} traffic exceeds compute even "
                    f"with perfect overlap; {remedy}")
    elif r_nominal >= 1.0:
        recs.append(f"no headroom at the published rate (r={r:.2f} at {gemm_tflops:.0f} "
                    f"TF/s, {r_nominal:.2f} at {nominal_tflops:.0f} TF/s): the {dominant} "
                    f"traffic hides only behind GEMMs slower than the card's peak; {remedy}")
    elif r > 0.9:
        recs.append(f"marginal (r={r:.2f}): under 10% overlap slack; any loss of overlap "
                    "shows up directly in step time")

    return {
        "d": d,
        "mesh": mesh_cfg.shape,
        "ring": ring,
        "batch": batch,
        "seqlen": seqlen,
        "mode": mode,
        "t_compute_ms": t_compute * 1e3,
        "t_link_ms": t_link * 1e3,
        "allreduce_bytes": int(allreduce),
        "weight_gather_bytes": int(weight_gather),
        "ring_bytes": int(ring_bytes),
        "link_bytes": int(link_bytes),
        "r": r,
        "r_nominal": r_nominal,
        "efficiency_overlapped": min(1.0, 1.0 / r) if r > 0 else 1.0,
        "efficiency_serial": 1.0 / (1.0 + r),
        "recommendations": recs,
    }


# The layouts PERF.md's table documents: esm_tpu's five (:282) and the
# four-card ESM2-15B training step. label -> plan_scaling's arguments.
DOC_ROWS = (
    ("650M (d=1280) B=8 T=1024, tp=4",
     dict(cfg=1280, mesh_cfg=MeshConfig(1, 1, 4), batch=8, seqlen=1024)),
    ("3B (d=2560) B=8 T=1024, tp=4",
     dict(cfg=2560, mesh_cfg=MeshConfig(1, 1, 4), batch=8, seqlen=1024)),
    ("15B (d=5120) B=8 T=1024, fsdp=4×tp=2",
     dict(cfg=5120, mesh_cfg=MeshConfig(1, 4, 2), batch=8, seqlen=1024)),
    ("15B B=1 T=1024, fsdp=4×tp=2",
     dict(cfg=5120, mesh_cfg=MeshConfig(1, 4, 2), batch=1, seqlen=1024)),
    ("650M seq-parallel B=1 T=8192, ring N=4",
     dict(cfg=1280, mesh_cfg=MeshConfig(1, 1, 1), batch=1, seqlen=8192, ring=4)),
    ("15B B=8 T=1024, fsdp=4, training step",
     dict(cfg=5120, mesh_cfg=MeshConfig(1, 4, 1), batch=8, seqlen=1024, mode="train")),
)


def _fmt_bytes(row: Dict) -> str:
    mb = lambda b: f"{b / 2**20:.0f} MB"  # noqa: E731
    parts = []
    if row["allreduce_bytes"]:
        parts.append(f"{mb(row['allreduce_bytes'])} AR")
    if row["weight_gather_bytes"]:
        parts.append(f"{mb(row['weight_gather_bytes'])} weights")
    if row["ring_bytes"]:
        parts.append(f"{mb(row['ring_bytes'])} KV ring")
    return " + ".join(parts) if parts else "0"


def scaling_table(rows=DOC_ROWS, **kw) -> str:
    """The markdown table of ``rows`` (PERF.md embeds the default's;
    regenerate with ``python -m esm_tpu_torch.parallel.scaling``)."""
    lines = [
        "| layout | t_compute/rank/layer | link bytes/rank/layer | t_link | r | eff. overlapped "
        "| eff. serial |",
        "|---|---|---|---|---|---|---|",
    ]
    for label, args in rows:
        p = plan_scaling(**args, **kw)
        lines.append(
            f"| {label} | {p['t_compute_ms']:.3f} ms | {_fmt_bytes(p)} "
            f"| {p['t_link_ms']:.3f} ms | {p['r']:.2f} "
            f"| {p['efficiency_overlapped'] * 100:.0f}% | {p['efficiency_serial'] * 100:.0f}% |"
        )
    return "\n".join(lines)


def warn_if_inefficient(cfg, mesh_cfg: MeshConfig, batch: int, seqlen: int, **kw) -> Dict:
    """plan_scaling and a ``warnings.warn`` per recommendation: called where
    a mesh is chosen for real work (``cli.pretrain``,
    ``examples.esm2_infer_sharded``), so a layout the model calls bad is not
    picked silently."""
    p = plan_scaling(cfg, mesh_cfg, batch, seqlen, **kw)
    for rec in p["recommendations"]:
        warnings.warn(f"mesh {mesh_cfg.shape}: {rec}", stacklevel=2)
    return p


if __name__ == "__main__":
    print(scaling_table())
