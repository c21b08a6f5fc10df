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

:func:`plan_scaling_fold` models the sharded fold (``esmfold.apply_sharded``,
esm_tpu :159): per trunk block the O(L³) triangle products and the pair
projections divided over the pair-row shards, and the bytes of the port's
collectives (``parallel/pair_sharding.py``); ``esm_tpu_bytes=True`` gives
esm_tpu's byte formula. The tables, :func:`scaling_table` and
:func:`fold_scaling_table`, are in PERF.md (generated; a test holds them
equal).
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
# The NCCL all-reduce bus bandwidth of four H100s over NVLink at 84 MB (the
# 15B tp all-reduce's bf16 (8 x 1024, 5120) activation): 311.8-312.9 GB/s,
# 246.9-255.1 at 21 MB (chip_smoke.py [shard], NVIDIA H100 80GB HBM3 at
# 700.00 W, PERF.md §6); NVLink 4's nominal rate is 450 GB/s each way.
LINK_GBPS = 312.9


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


def _itemsize(dtype) -> int:
    """Bytes of an element of a torch dtype, or of a dtype's name (bf16: 2)."""
    if isinstance(dtype, str):
        return 2 if "bfloat16" in dtype else 4
    return dtype.itemsize


def plan_scaling_fold(
    fcfg,
    mesh_cfg: MeshConfig,
    seqlen: int,
    batch: int = 1,
    *,
    num_recycles=None,
    gemm_tflops: float = GEMM_TFLOPS_MEASURED,
    link_gbps: float = LINK_GBPS,
    nominal_tflops: float = GEMM_TFLOPS_NOMINAL,
    esm_tpu_bytes: bool = False,
) -> Dict:
    """Compute and link time of one sharded fold (``esmfold.apply_sharded``:
    the ring-parallel LM, the trunk's pair rows over the mesh's tp ranks, the
    pair heads on the local rows), the fold's counterpart of
    :func:`plan_scaling` (esm_tpu :159).

    fcfg: an ESMFoldConfig (reads .trunk.{num_blocks, pairwise_state_dim,
    pairwise_head_width, sequence_state_dim, max_recycles, compute_dtype,
    structure_module.{c_s, no_blocks}}, .esm.{embed_dim, num_layers} and
    .distogram_bins). One fold's batch is replicated over data and fsdp.

    Compute per trunk block, as esm_tpu counts it: the two tri-muls (4 B L³
    c_z) and two triangle attentions (8 B L³ c_z) and the pair projections
    and MLP (44 B L² c_z²) over tp; the sequence track (24 B L c_s²) whole.
    Link bytes a rank receives, per block (N = tp, zb the compute dtype's
    bytes): the outgoing tri-mul gathers b and the incoming one gathers b
    and moves a to columns; each triangle attention gathers its (B, L, L, H)
    bias, and the ending-node one moves z, its mask and its output between
    rows and columns; the sequence attention gathers its (B, L, c_s) output:

        gather  (N-1)/N  B zb (2 L² c_z + 2 L² H + L c_s)
        a2a     (N-1)/N² B zb L² (3 c_z + 1)

    per pass, IPA gathers its (B, L, c_s) fp32 output in every structure
    block; once, the distogram's transpose moves its fp32 logits ((N-1)/N²
    B L² bins 4) and the LM its ring's key/value blocks (:func:`plan_scaling`
    with ring = N) and gathers its (B, L, C) fp32 output. ``esm_tpu_bytes``:
    esm_tpu's formula instead (2 gathers and 2 all-to-alls of c_z per block,
    the head's transpose at c_z, the LM's ring).

    Returns t_compute_ms, t_link_ms for the whole fold (passes x blocks, the
    structure module, the heads and the LM), the byte breakdown, r,
    r_nominal, the efficiencies and ``recommendations``."""
    tcfg = fcfg.trunk
    c_z, c_s = tcfg.pairwise_state_dim, tcfg.sequence_state_dim
    heads = c_z // tcfg.pairwise_head_width
    n_blocks = tcfg.num_blocks
    passes = tcfg.max_recycles if num_recycles is None else num_recycles + 1
    zb = _itemsize(getattr(tcfg, "compute_dtype", "float32"))
    tp = mesh_cfg.tp
    b, l = batch, seqlen
    spread, swap = (tp - 1) / tp, (tp - 1) / tp ** 2

    flops_tri = 12.0 * b * l ** 3 * c_z / tp
    flops_pair = 44.0 * b * l ** 2 * c_z ** 2 / tp
    flops_seq = 24.0 * b * l * c_s ** 2  # the sequence track, whole on every rank
    t_block = (flops_tri + flops_pair + flops_seq) / (gemm_tflops * 1e12)
    t_block_nominal = (flops_tri + flops_pair + flops_seq) / (nominal_tflops * 1e12)

    if esm_tpu_bytes:
        gather_bytes = 2.0 * spread * b * l * l * c_z * zb
        a2a_bytes = 2.0 * swap * b * l * l * c_z * zb
        head_a2a = swap * b * l * l * c_z * 4.0
        pass_bytes = lm_gather = 0.0
    else:
        sm = tcfg.structure_module
        gather_bytes = spread * b * zb * (2 * l * l * c_z + 2 * l * l * heads + l * c_s)
        a2a_bytes = swap * b * zb * l * l * (3 * c_z + 1)
        head_a2a = swap * b * l * l * fcfg.distogram_bins * 4.0
        pass_bytes = sm.no_blocks * spread * b * l * sm.c_s * 4.0
        lm_gather = spread * b * l * fcfg.esm.embed_dim * 4.0

    lm = plan_scaling(fcfg.esm.embed_dim, MeshConfig(1, 1, 1), batch, seqlen, ring=tp,
                      gemm_tflops=gemm_tflops, link_gbps=link_gbps,
                      nominal_tflops=nominal_tflops)
    n_lm = fcfg.esm.num_layers
    t_compute = passes * n_blocks * t_block + n_lm * lm["t_compute_ms"] / 1e3
    t_compute_nominal = passes * n_blocks * t_block_nominal + n_lm * lm[
        "t_compute_ms"] / 1e3 * (gemm_tflops / nominal_tflops)
    link_bytes = (passes * n_blocks * (gather_bytes + a2a_bytes) + head_a2a
                  + n_lm * lm["ring_bytes"] + passes * pass_bytes + lm_gather)
    t_link = link_bytes / (link_gbps * 1e9)

    r = t_link / t_compute if t_compute > 0 else math.inf
    r_nominal = t_link / t_compute_nominal if t_compute_nominal > 0 else math.inf
    recs: List[str] = []
    if r >= 1.0:
        recs.append(f"link-bound fold (r={r:.2f}): the pair-row collectives exceed the "
                    f"trunk's compute even with perfect overlap; use fewer pair shards "
                    f"(tp={max(tp // 2, 1)}) or fold longer sequences this way")
    elif r_nominal >= 1.0:
        recs.append(f"no headroom for the fold at the published rate (r={r:.2f} at "
                    f"{gemm_tflops:.0f} TF/s, {r_nominal:.2f} at {nominal_tflops:.0f} TF/s)")
    elif r > 0.9:
        recs.append(f"marginal fold overlap (r={r:.2f})")

    return {
        "mesh": mesh_cfg.shape,
        "seqlen": seqlen,
        "batch": batch,
        "passes": passes,
        "n_blocks": n_blocks,
        "t_compute_ms": t_compute * 1e3,
        "t_link_ms": t_link * 1e3,
        "block_gather_bytes": int(gather_bytes),
        "block_a2a_bytes": int(a2a_bytes),
        "pass_gather_bytes": int(pass_bytes),
        "head_a2a_bytes": int(head_a2a),
        "lm_ring_bytes": int(n_lm * lm["ring_bytes"]),
        "lm_gather_bytes": int(lm_gather),
        "link_bytes": int(link_bytes),
        "r": r,
        "r_nominal": r_nominal,
        "efficiency_overlapped": min(1.0, 1.0 / r) if r > 0 else 1.0,
        "efficiency_serial": 1.0 / (1.0 + r),
        "recommendations": recs,
    }


def _fold_dims(lm_width: int, lm_layers: int, n_blocks: int = 48, c_z: int = 128,
               c_s: int = 1024):
    """A stand-in ESMFoldConfig for the table's rows (esm_tpu :322): the
    reference trunk's shape (esm/esmfold/v1/trunk.py:35-51), bf16 compute,
    the released structure module and heads."""
    from types import SimpleNamespace as NS

    return NS(
        trunk=NS(num_blocks=n_blocks, pairwise_state_dim=c_z, pairwise_head_width=32,
                 sequence_state_dim=c_s, max_recycles=4, compute_dtype="bfloat16",
                 structure_module=NS(c_s=384, no_blocks=8)),
        esm=NS(embed_dim=lm_width, num_layers=lm_layers),
        distogram_bins=64,
    )


# The sharded folds PERF.md's table documents: esm_tpu's three (:347) and
# ESMFold v1 at the lengths that place the crossover and at the four-card
# check's (L=2048, one recycle). label -> plan_scaling_fold's arguments.
FOLD_DOC_ROWS = (
    ("esmfold_v1 (3B LM, 48 blk) L=1024, pair tp=4, 4 passes",
     dict(fcfg=_fold_dims(2560, 36), mesh_cfg=MeshConfig(1, 1, 4), seqlen=1024)),
    ("650M-LM 48-blk L=2048, pair tp=4, 4 passes",
     dict(fcfg=_fold_dims(1280, 33), mesh_cfg=MeshConfig(1, 1, 4), seqlen=2048)),
    ("650M-LM 48-blk L=512, pair tp=8, 4 passes",
     dict(fcfg=_fold_dims(1280, 33), mesh_cfg=MeshConfig(1, 1, 8), seqlen=512)),
    ("esmfold_v1 L=512, pair tp=4, 4 passes",
     dict(fcfg=_fold_dims(2560, 36), mesh_cfg=MeshConfig(1, 1, 4), seqlen=512)),
    ("esmfold_v1 L=2048, pair tp=4, 2 passes",
     dict(fcfg=_fold_dims(2560, 36), mesh_cfg=MeshConfig(1, 1, 4), seqlen=2048,
          num_recycles=1)),
    ("esmfold_v1 L=3072, pair tp=4, 1 pass",
     dict(fcfg=_fold_dims(2560, 36), mesh_cfg=MeshConfig(1, 1, 4), seqlen=3072,
          num_recycles=0)),
)


def fold_scaling_table(rows=FOLD_DOC_ROWS, **kw) -> str:
    """The sharded fold's markdown table (PERF.md embeds the default's;
    ``python -m esm_tpu_torch.parallel.scaling`` prints it)."""
    lines = [
        "| fold layout | t_compute | t_link | link GB (gather / a2a / LM) | r | eff. overlapped "
        "| eff. serial |",
        "|---|---|---|---|---|---|---|",
    ]
    gb = lambda x: f"{x / 1e9:.2f}"  # noqa: E731
    for label, args in rows:
        p = plan_scaling_fold(**args, **kw)
        per_pass = p["passes"] * p["n_blocks"]
        gather = per_pass * p["block_gather_bytes"] + p["passes"] * p["pass_gather_bytes"]
        a2a = per_pass * p["block_a2a_bytes"] + p["head_a2a_bytes"]
        lm = p["lm_ring_bytes"] + p["lm_gather_bytes"]
        lines.append(
            f"| {label} | {p['t_compute_ms'] / 1e3:.3f} s | {p['t_link_ms'] / 1e3:.3f} s "
            f"| {gb(gather)} / {gb(a2a)} / {gb(lm)} | {p['r']:.2f} "
            f"| {p['efficiency_overlapped'] * 100:.0f}% | {p['efficiency_serial'] * 100:.0f}% |")
    return "\n".join(lines)


def fold_crossover_length(fcfg, mesh_cfg: MeshConfig, *, step: int = 64, longest: int = 16384,
                          **kw) -> int:
    """The shortest L (a multiple of ``step``) from which on, up to
    ``longest``, the sharded fold's collectives take less time than its
    compute (r < 1: overlapped they could hide, serial they cost less than
    half); shorter folds spend more time moving pair rows than computing.
    0 when r >= 1 at ``longest``. ``kw``: :func:`plan_scaling_fold`'s
    keywords."""
    crossover = step
    for length in range(step, longest + 1, step):
        if plan_scaling_fold(fcfg, mesh_cfg, length, **kw)["r"] >= 1.0:
            crossover = length + step
    return crossover if crossover <= longest else 0


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
    print()
    print(fold_scaling_table())
    print()
    v1 = _fold_dims(2560, 36)
    for tp in (2, 4, 8):
        print(f"esmfold_v1, pair tp={tp}: link time below compute (r < 1) from "
              f"L={fold_crossover_length(v1, MeshConfig(1, 1, tp))}")
