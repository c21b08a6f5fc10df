"""Device-memory planning for an ESMFold fold on one device.

Port of the fold planner of esm_tpu/parallel/memory_plan.py:84-232
(``_held_output_bytes_per_pair``, ``plan_fold``, ``max_fold_length``) for
one device: no mesh, a pair-shard factor of 1. ``hbm_bytes=None`` means the
memory of the device the caller names (``device``; the GPU when none is
named): the card's ``total_memory``, or the host's physical memory for the
CPU. The server derives its fold-length cap from ``max_fold_length``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def device_memory_bytes(device=None) -> int:
    """Bytes of memory of ``device``: a CUDA device's ``total_memory``, or the
    host's physical memory for the CPU. ``None`` is the GPU, which must exist."""
    from ..pretrained import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


# Compute-dtype pair tensors the trunk holds at its peak, beside s_z_0 and
# the recycle carry (fp32). esm_tpu charges 4 (z and ~3 triangle-mul
# temporaries of XLA's fused program). The port's eager trunk holds more:
# the card's peak over a fast-preset ESMFold v1 fold (max_memory_reserved at
# B=1, L=256-2048, bf16 trunk with K6), less its parameters and LM
# activations, came to 52-60 bytes per pair channel where that model charges
# 16 (chip_smoke.py [serve]; NVIDIA H100 80GB HBM3, 700.00 W): 24 bf16
# tensors and the two fp32 ones charge 56. fp32 trunks are not measured.
PAIR_TEMPS = 24


# Held bytes per (i, j) pair entry of one NON-frugal ESMFold output dict:
# s_z (c_z fp32) + distogram/ptm/aligned-confidence logits (3 x bins fp32)
# + predicted_aligned_error (fp32). The frugal mode keeps only the PAE.
def _held_output_bytes_per_pair(c_z: int = 128, distogram_bins: int = 64) -> int:
    return c_z * 4 + 3 * distogram_bins * 4 + 4


def plan_fold(
    fold_cfg,
    L: int,
    *,
    batch: int = 1,
    lm_dtype_bytes: int = 2,
    params_bytes: Optional[int] = None,
    frugal: Optional[bool] = None,
    held_outputs: int = 1,
    hbm_bytes: Optional[int] = None,
    device=None,
) -> Dict:
    """Estimate the device memory of an ESMFold forward at length ``L`` and
    answer "does this fit?" before a trial out-of-memory.

    fold_cfg: an ESMFoldConfig (uses .esm, .trunk, .distogram_bins).
    lm_dtype_bytes: 2 for a bf16/fp16 LM, 4 fp32, 1 for weight-only int8
        (parameters only; LM activations are charged at max(2, lm_dtype_bytes)).
    params_bytes: total parameter bytes if known (measured from the live
        module); otherwise estimated analytically from the configs.
    frugal: whether outputs use the frugal mode; None = ``auto_frugal``.
    held_outputs: output dicts alive at once (2 when a caller keeps the
        previous result while folding the next).
    hbm_bytes: the device's memory; None = ``device_memory_bytes(device)``.

    Model: trunk working set = s_z_0 + recycle carry (fp32) + PAIR_TEMPS
    compute-dtype pair tensors + recycle bins [+ the O(L^3) unchunked
    triangle-attention logits when neither chunk_size nor use_flash_tri is
    set]; LM = fp32 per-layer representation stack (+ attention-map stack
    when use_esm_attn_map); outputs per _held_output_bytes_per_pair. The
    verdict is "fits" with 10% of the device free, "close" down to 5% over,
    else "over"; use the verdict, not the raw number.
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    esm_cfg, trunk_cfg = fold_cfg.esm, fold_cfg.trunk
    c_z = trunk_cfg.pairwise_state_dim
    tb = trunk_cfg.compute_dtype.itemsize
    pairs = batch * L * L

    if params_bytes is None:
        # LM + trunk parameter counts, analytic (init_esmfold's shapes to ~5%:
        # embeddings/LN/head terms included, biases in the structural slack)
        d, nl = esm_cfg.embed_dim, esm_cfg.num_layers
        lm_params = nl * 12 * d * d + 2 * esm_cfg.alphabet_size * d
        c_s = trunk_cfg.sequence_state_dim
        block = (
            8 * c_z * c_z          # tri-mul in/out: 2 ops x (2 proj + gates)
            + 4 * c_z * c_z        # tri-attn start/end qkv+out at width c_z
            + 12 * c_s * c_s       # seq attention + 4x MLP
            + 2 * c_s * c_z + 2 * c_z * c_s  # seq<->pair couplings
            + 8 * c_z * c_z        # pair MLP (4x hidden)
        )
        sm = trunk_cfg.structure_module
        sm_params = sm.no_blocks * 16 * sm.c_s * sm.c_s + 4 * sm.c_s * sm.c_z
        params_bytes = (
            lm_params * lm_dtype_bytes
            + (trunk_cfg.num_blocks * block + sm_params
               + 2 * esm_cfg.embed_dim * c_s) * max(tb, 2)
        )

    # LM activations: the fp32 (layers+1, C) representation stack, + the
    # transient layer working set
    act_b = max(2, lm_dtype_bytes)
    lm_act = batch * (L + 2) * (esm_cfg.num_layers + 1) * esm_cfg.embed_dim * 4
    lm_act += 10 * batch * L * esm_cfg.embed_dim * act_b
    if fold_cfg.use_esm_attn_map:
        lm_act += pairs * esm_cfg.num_layers * esm_cfg.attention_heads * 4

    z32 = pairs * c_z * 4
    zc = pairs * c_z * tb
    # s_z_0 + carry (fp32) + PAIR_TEMPS compute-dtype pair tensors + bins
    trunk_work = 2 * z32 + PAIR_TEMPS * zc + pairs * 4
    if trunk_cfg.chunk_size is None and not trunk_cfg.use_flash_tri:
        # unchunked triangle attention materializes (B, I, H, J, J) logits
        trunk_work += batch * L * trunk_cfg.pair_heads * L * L * 4

    if frugal is None:
        from ..models.esmfold.esmfold import auto_frugal

        frugal = auto_frugal(batch, L)
    out_pair_bytes = (
        4 if frugal else _held_output_bytes_per_pair(c_z, fold_cfg.distogram_bins)
    )
    sm_k = trunk_cfg.structure_module.no_blocks
    out_linear = batch * L * (37 * 4 + sm_k * 14 * 3 * 4)  # plddt + positions
    if not frugal:
        out_linear += batch * L * sm_k * (
            37 * fold_cfg.lddt_bins * 4 + trunk_cfg.structure_module.c_s * 4
        )  # lddt_head + states
    outputs = held_outputs * (pairs * out_pair_bytes + out_linear)

    total = params_bytes + lm_act + trunk_work + outputs
    headroom = hbm_bytes - total
    verdict = (
        "fits" if headroom > 0.1 * hbm_bytes
        else ("close" if headroom > -0.05 * hbm_bytes else "over")
    )
    return {
        "per_device_bytes": int(total),
        "params_bytes": int(params_bytes),
        "lm_bytes": int(lm_act),
        "pair_bytes": int(trunk_work),
        "output_bytes": int(outputs),
        "pair_shards": 1,
        "frugal": bool(frugal),
        "hbm_bytes": int(hbm_bytes),
        "verdict": verdict,
    }


def max_fold_length(fold_cfg, *, include_close: bool = False, **kw) -> int:
    """Largest L whose plan_fold verdict is "fits" (binary search; 0 when not
    even L=64 fits).

    The default excludes "close": the plan is an estimate, and a cap taken
    from the not-"over" edge admits folds that run out of memory (and,
    co-batched, take other requests down with them). Pass
    ``include_close=True`` only for what-if estimates, never for admission
    caps. ``kw``: plan_fold's keywords; give ``hbm_bytes`` (or ``device``)
    once, the search resolves it once."""
    if kw.get("hbm_bytes") is None:
        kw["hbm_bytes"] = device_memory_bytes(kw.pop("device", None))
    admit = ("fits", "close") if include_close else ("fits",)
    lo, hi = 64, 16384
    if plan_fold(fold_cfg, lo, **kw)["verdict"] not in admit:
        return 0
    while plan_fold(fold_cfg, hi, **kw)["verdict"] in admit and hi < 2**20:
        lo, hi = hi, hi * 2
    while hi - lo > 16:
        mid = (lo + hi) // 2
        if plan_fold(fold_cfg, mid, **kw)["verdict"] in admit:
            lo = mid
        else:
            hi = mid
    return lo
