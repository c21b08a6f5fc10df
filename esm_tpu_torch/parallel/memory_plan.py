"""Device-memory planning: an ESM-2 on a (data, fsdp, tp) mesh, its training
step, and an ESMFold fold on one device or row-sharded over a mesh.

Port of esm_tpu/parallel/memory_plan.py. The mesh half (:func:`plan`,
:func:`plan_model`, :func:`plan_train`, :func:`plan_train_lora`) charges a
rank the parameter bytes that ``parallel.sharding.shard_params`` leaves on
it, exactly: the specs are the sharding's, and shards are even (the
sharding refuses the others; esm_tpu's plan takes the ceiling). The model
is built on the ``meta`` device, so no memory is allocated. The fold half
(:func:`_pair_shards`, ``_held_output_bytes_per_pair``, :func:`plan_fold`,
:func:`max_fold_length`, esm_tpu :66-232) divides the pair tensors by the
shard factor of ``trunk.pair_spec`` on the mesh (``esmfold.apply_sharded``)
and charges the sharded fold's own terms (``port_terms``).

The training plan's activation term is the eager port's, measured on the
card (``ACT_UNITS``; esm_tpu's 10 through ``act_units``), as the fold's
working set is (``PAIR_TEMPS``); the LoRA plan's with ``port_terms``
(``LORA_ACT_UNITS``; esm_tpu's 15 without). Both charge, with
``port_terms``, what an fsdp step of the port holds beyond its state
(:func:`fsdp_transient_bytes`); ``port_terms=False`` gives esm_tpu's
formula. ``hbm_bytes=None`` means the memory
of the device the caller names (``device``; the GPU when none is named):
the card's ``total_memory``, or the host's physical memory for the CPU.
The server derives its fold-length cap from ``max_fold_length``.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import torch

from .mesh import AXES, MeshConfig


def device_memory_bytes(device=None) -> int:
    """Bytes of memory of ``device``: a CUDA device's ``total_memory``, or the
    host's physical memory for the CPU. ``None`` is the GPU, which must exist."""
    from ..pretrained import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


# bf16 values a training step holds per layer, per token and per feature:
# the saved matrix-product outputs of remat "dots" with flash attention;
# esm_tpu charges 10 (XLA's fused program). The eager port's steps fit 7.81
# (ESM2-650M, B=8 x 1024: peak 15.822 GB) and 3.98 (ESM2-3B, B=8 x 1024:
# 51.437 GB) on the card (chip_smoke.py [shard]; NVIDIA H100 80GB HBM3,
# 700.00 W); 8 covers both (+0.9% and +12% over their peaks).
ACT_UNITS = 8
# The same for a LoRA step (remat "dots", flash): each adapted product adds
# its term's saved outputs, (x a) and (x a) b, the latter as wide as the
# product's own; esm_tpu charges 15. The port's rank-16 steps fit 19.97 (bf16
# base) and 19.7 (int8) at ESM2-650M, B=8 x 1024 (peaks 15.321 and 14.650
# GB; chip_smoke.py [shard], NVIDIA H100 80GB HBM3, 700.00 W).
LORA_ACT_UNITS = 20


def fsdp_transient_bytes(cfg, mesh_cfg: MeshConfig, gathered_bytes: float,
                         grad_bytes: float = 0.0) -> int:
    """What a rank's fsdp step holds beyond its state and activations (the
    port's ZeRO-3 gather, ``parallel.tensor_parallel.gather_param``): one
    layer's linear weights gathered whole over fsdp (their tp shard, 12 D^2 /
    tp elements) at ``gathered_bytes`` an element, twice (the forward's, or
    the remat recompute's, and the backward's), and that layer's whole
    gradient before the reduce-scatter at ``grad_bytes`` an element (in the
    compute dtype, then the parameter's). 0 without an fsdp axis (the
    gather is the identity)."""
    if mesh_cfg.fsdp == 1:
        return 0
    layer = 12 * cfg.embed_dim * cfg.embed_dim // mesh_cfg.tp
    return int(layer * (2 * gathered_bytes + grad_bytes))


def _verdict(total: float, hbm_bytes: int) -> str:
    """"fits" with 10% of the device free, "close" down to 5% over, else "over"."""
    headroom = hbm_bytes - total
    if headroom > 0.1 * hbm_bytes:
        return "fits"
    return "close" if headroom > -0.05 * hbm_bytes else "over"


def plan(model: torch.nn.Module, mesh_cfg: MeshConfig, dtype_bytes: Optional[int] = None) -> Dict:
    """{"total_bytes", "per_device_bytes", "largest_param_bytes"} of a model's
    parameters and int8 scales on ``mesh_cfg`` (esm_tpu :18): each entry
    divided by the shard factor of its spec (``sharding.param_specs``).
    ``model`` may live on the ``meta`` device. ``dtype_bytes`` overrides
    every entry's element size. The largest parameter is esm_tpu's largest
    leaf: one parameter's tensors in all layers (``io.from_jax.jax_leaf``)."""
    from ..io.from_jax import jax_leaf
    from .sharding import _sharded_entries, param_specs, shard_factor

    sizes = dict(zip(AXES, mesh_cfg.shape))
    specs = param_specs(model)
    total = per_dev = 0
    leaves: Dict[tuple, int] = {}
    for name, t in _sharded_entries(model).items():
        nbytes = t.numel() * (dtype_bytes or t.element_size())
        shard_bytes = -(-nbytes // shard_factor(specs[name], sizes))
        total += nbytes
        per_dev += shard_bytes
        leaf = jax_leaf(name)[0]
        leaves[leaf] = leaves.get(leaf, 0) + shard_bytes
    return {"total_bytes": total, "per_device_bytes": per_dev,
            "largest_param_bytes": max(leaves.values(), default=0)}


@functools.lru_cache(maxsize=8)
def _meta_model(cfg, dtype: Optional[torch.dtype]) -> torch.nn.Module:
    from ..models import esm2

    model = esm2.ESM2(cfg, device="meta")
    return model if dtype is None else model.to(dtype)


def plan_model(cfg, mesh_cfg: MeshConfig, dtype: Optional[torch.dtype] = None) -> Dict:
    """:func:`plan` of an ESM-2 of ``cfg`` built on the meta device (no
    memory allocated), its parameters in ``dtype`` (fp32 by default)."""
    return plan(_meta_model(cfg, dtype), mesh_cfg)


def plan_train(
    cfg,
    mesh_cfg: MeshConfig,
    batch: int,
    seqlen: int,
    *,
    accum_steps: int = 1,
    mu_dtype_bytes: int = 4,
    factored: bool = False,
    seq_shards: int = 1,
    hbm_bytes: Optional[int] = None,
    device=None,
    act_units: float = ACT_UNITS,
    port_terms: bool = True,
) -> Dict:
    """Estimate a rank's memory for one MLM training step (AdamW, remat and
    flash attention: the configuration ``training.train_step`` targets;
    esm_tpu :235).

    Model: fp32 parameters + AdamW mu/nu + gradients (+ an accumulation
    buffer) + the activations: per layer ``act_units`` x D x T x B bf16
    values of saved products, and the fp32 logits. B
    and T are a rank's (the batch over data x fsdp, T over ``seq_shards``).
    ``port_terms`` adds the fsdp gather's transients
    (:func:`fsdp_transient_bytes`: weights in the compute dtype, the
    gradient in it and in fp32) as ``fsdp_bytes``; False is esm_tpu's
    formula. Use the verdict ("fits" / "close" / "over"), not the raw
    number."""
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    per_dev_params = plan_model(cfg, mesh_cfg)["per_device_bytes"]
    if factored:  # adafactor: row/column statistics only, no mu
        opt = per_dev_params // 500
    else:
        opt = per_dev_params * (mu_dtype_bytes / 4.0) + per_dev_params  # mu + nu
    grads = per_dev_params
    micro_b = max(1, batch // accum_steps)
    accum_buf = per_dev_params if accum_steps > 1 else 0
    dp = mesh_cfg.data * mesh_cfg.fsdp
    b_local = -(-micro_b // dp)
    d = cfg.embed_dim
    t_local = -(-seqlen // max(seq_shards, 1))
    acts = cfg.num_layers * (act_units * d * t_local * b_local * 2)
    logits = b_local * t_local * getattr(cfg, "alphabet_size", 33) * 4
    total = per_dev_params + opt + grads + accum_buf + acts + logits
    out = {
        "params_bytes": int(per_dev_params),
        "optimizer_bytes": int(opt),
        "grads_bytes": int(grads + accum_buf),
        "activations_bytes": int(acts + logits),
        "hbm_bytes": hbm_bytes,
    }
    if port_terms:
        cdt = cfg.compute_dtype.itemsize
        out["fsdp_bytes"] = fsdp_transient_bytes(cfg, mesh_cfg, cdt, cdt + 4)
        total += out["fsdp_bytes"]
    return {"per_device_bytes": int(total), **out, "verdict": _verdict(total, hbm_bytes)}


def plan_train_lora(
    cfg,
    mesh_cfg: MeshConfig,
    batch: int,
    seqlen: int,
    *,
    rank: int,
    base_dtype_bytes: int = 2,
    remat_policy: str = "dots",
    seq_shards: int = 1,
    hbm_bytes: Optional[int] = None,
    device=None,
    port_terms: bool = True,
) -> Dict:
    """Estimate a rank's memory for one LoRA step (``training.train_step_lora``;
    esm_tpu :297): the frozen base in its storage dtype (2 = bf16, 1 = int8,
    4 = fp32) + fp32 adapters with AdamW moments and gradients + the
    activations: 15 x D x T x B x 2 bytes a layer under "dots", the layer
    inputs and one layer's recompute under "full"; an int8 base adds
    12 x D^2 x 2 x 4 bytes of backward weight transients. ``port_terms``
    charges the eager port's activations (``LORA_ACT_UNITS`` for esm_tpu's
    15) and adds the fsdp gather's transients (the frozen base's weights as
    gathered: int8, or the compute dtype; no weight gradient) as
    ``fsdp_bytes``; False is esm_tpu's formula.
    Use the verdict, not the raw number."""
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes(device)
    bf16 = plan_model(cfg, mesh_cfg, dtype=torch.bfloat16)["per_device_bytes"]
    base = bf16 // 2 if base_dtype_bytes == 1 else bf16 * (base_dtype_bytes // 2)
    d = cfg.embed_dim
    # q/k/v/o: 4(D r + r D) = 8 D r; fc1/fc2: (D r + r 4D) + (4D r + r D) = 10 D r
    adapters = cfg.num_layers * 18 * d * rank * 4  # fp32
    opt = 2 * adapters
    grads = adapters
    dp = mesh_cfg.data * mesh_cfg.fsdp
    b_local = -(-batch // dp)
    t_local = -(-seqlen // max(seq_shards, 1))
    layer_body = (LORA_ACT_UNITS if port_terms else 15) * d * t_local * b_local * 2
    if remat_policy == "full":
        acts = cfg.num_layers * (b_local * t_local * d * 2) + layer_body
    else:
        acts = cfg.num_layers * layer_body
    weight_transients = 12 * d * d * 2 * 4 if base_dtype_bytes == 1 else 0
    logits = b_local * t_local * getattr(cfg, "alphabet_size", 33) * 4
    total = base + adapters + opt + grads + acts + weight_transients + logits
    out = {
        "params_bytes": int(base),
        "adapter_bytes": int(adapters),
        "optimizer_bytes": int(opt),
        "grads_bytes": int(grads),
        "activations_bytes": int(acts + logits),
        "weight_transient_bytes": int(weight_transients),
        "hbm_bytes": hbm_bytes,
    }
    if port_terms:
        gathered = 1 if base_dtype_bytes == 1 else cfg.compute_dtype.itemsize
        out["fsdp_bytes"] = fsdp_transient_bytes(cfg, mesh_cfg, gathered)
        total += out["fsdp_bytes"]
    return {"per_device_bytes": int(total), **out, "verdict": _verdict(total, hbm_bytes)}


# Compute-dtype pair tensors the trunk holds at its peak, beside s_z_0 and
# the recycle carry (fp32). esm_tpu charges 4 (z and ~3 triangle-mul
# temporaries of XLA's fused program). The port's eager trunk holds more:
# the card's peak over a fast-preset ESMFold v1 fold (max_memory_reserved at
# B=1, L=256-2048, bf16 trunk with K6), less its parameters and LM
# activations, came to 52-60 bytes per pair channel where that model charges
# 16 (chip_smoke.py [serve]; NVIDIA H100 80GB HBM3, 700.00 W): 24 bf16
# tensors and the two fp32 ones charge 56. fp32 trunks are not measured.
PAIR_TEMPS = 24


def _pair_shards(pair_spec, mesh_cfg: Optional[MeshConfig]) -> int:
    """The shard factor the fold's (B, I, J, C) pair tensors get from
    ``trunk.pair_spec`` on ``mesh_cfg`` (esm_tpu :66): the product of the
    sizes of the axes it names (None entries, and tuples of axes, as in a
    PartitionSpec)."""
    if pair_spec is None or mesh_cfg is None:
        return 1
    sizes = dict(zip(AXES, mesh_cfg.shape))
    shards = 1
    for axes in pair_spec:
        if axes is None:
            continue
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            shards *= sizes.get(ax, 1)
    return shards


# Held bytes per (i, j) pair entry of one NON-frugal ESMFold output dict:
# s_z (c_z fp32) + distogram/ptm/aligned-confidence logits (3 x bins fp32)
# + predicted_aligned_error (fp32). The frugal mode keeps only the PAE.
def _held_output_bytes_per_pair(c_z: int = 128, distogram_bins: int = 64) -> int:
    return c_z * 4 + 3 * distogram_bins * 4 + 4


def plan_fold(
    fold_cfg,
    L: int,
    mesh_cfg: Optional[MeshConfig] = None,
    *,
    batch: int = 1,
    lm_dtype_bytes: int = 2,
    params_bytes: Optional[int] = None,
    frugal: Optional[bool] = None,
    held_outputs: int = 1,
    hbm_bytes: Optional[int] = None,
    device=None,
    port_terms: bool = True,
) -> Dict:
    """Estimate a device's memory for an ESMFold forward at length ``L`` and
    answer "does this fit?" before a trial out-of-memory. ``mesh_cfg``: the
    mesh of a sharded fold (``esmfold.apply_sharded``), whose pair tensors
    are divided by the shard factor of ``fold_cfg.trunk.pair_spec`` on it
    (esm_tpu :88); None or no pair_spec is one device.

    fold_cfg: an ESMFoldConfig (uses .esm, .trunk, .distogram_bins).
    lm_dtype_bytes: 2 for a bf16/fp16 LM, 4 fp32, 1 for weight-only int8
        (parameters only; LM activations are charged at max(2, lm_dtype_bytes)).
    params_bytes: total parameter bytes if known (measured from the live
        module); otherwise estimated analytically from the configs.
    frugal: whether outputs use the frugal mode; None = ``auto_frugal``.
    held_outputs: output dicts alive at once (2 when a caller keeps the
        previous result while folding the next).
    hbm_bytes: the device's memory; None = ``device_memory_bytes(device)``.
    port_terms: charge what the port's sharded fold holds beyond esm_tpu's
        model when the pair tensors are sharded: every parameter on every
        rank (esm_tpu divides them by fsdp x tp; the port's fold keeps its
        weights whole), the whole (B, L, L, c_z) tri-mul operand that
        ``pair_sharding.gather_rows`` gathers and the whole fp32 triangle
        bias (B, H, L, L) beside it, and v0's whole attention-map stack (its
        LM runs replicated). False gives esm_tpu's formula.

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
    shards = _pair_shards(trunk_cfg.pair_spec, mesh_cfg)
    sharded_terms = port_terms and shards > 1
    pairs = batch * L * L // shards

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
    if mesh_cfg is not None and not port_terms:
        params_bytes = -(-params_bytes // max(mesh_cfg.fsdp * mesh_cfg.tp, 1))

    # LM activations: the fp32 (layers+1, C) representation stack, + the
    # transient layer working set
    act_b = max(2, lm_dtype_bytes)
    lm_act = batch * (L + 2) * (esm_cfg.num_layers + 1) * esm_cfg.embed_dim * 4
    lm_act += 10 * batch * L * esm_cfg.embed_dim * act_b
    if fold_cfg.use_esm_attn_map:
        maps = batch * L * L if sharded_terms else pairs
        lm_act += maps * esm_cfg.num_layers * esm_cfg.attention_heads * 4

    z32 = pairs * c_z * 4
    zc = pairs * c_z * tb
    # s_z_0 + carry (fp32) + PAIR_TEMPS compute-dtype pair tensors + bins
    trunk_work = 2 * z32 + PAIR_TEMPS * zc + pairs * 4
    if trunk_cfg.chunk_size is None and not trunk_cfg.use_flash_tri:
        # unchunked triangle attention materializes (B, I, H, J, J) logits
        trunk_work += batch * L * trunk_cfg.pair_heads * L * L // shards * 4
    if sharded_terms:
        # the gathered tri-mul operand and fp32 triangle bias, whole on a rank
        trunk_work += batch * L * L * (c_z * tb + trunk_cfg.pair_heads * 4)

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
    verdict = _verdict(total, hbm_bytes)
    return {
        "per_device_bytes": int(total),
        "params_bytes": int(params_bytes),
        "lm_bytes": int(lm_act),
        "pair_bytes": int(trunk_work),
        "output_bytes": int(outputs),
        "pair_shards": shards,
        "frugal": bool(frugal),
        "hbm_bytes": int(hbm_bytes),
        "verdict": verdict,
    }


def max_fold_length(fold_cfg, mesh_cfg: Optional[MeshConfig] = None, *,
                    include_close: bool = False, **kw) -> int:
    """Largest L whose plan_fold verdict is "fits" on ``mesh_cfg`` (binary
    search; 0 when not even L=64 fits).

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
    if plan_fold(fold_cfg, lo, mesh_cfg, **kw)["verdict"] not in admit:
        return 0
    while plan_fold(fold_cfg, hi, mesh_cfg, **kw)["verdict"] in admit and hi < 2**20:
        lo, hi = hi, hi * 2
    while hi - lo > 16:
        mid = (lo + hi) // 2
        if plan_fold(fold_cfg, mid, mesh_cfg, **kw)["verdict"] in admit:
            lo = mid
        else:
            hi = mid
    return lo
