"""Parameter-efficient fine-tuning: LoRA adapters for any of the port's models.

Port of esm_tpu/lora.py. A frozen base keeps its weights (fp32, bf16 or
weight-only int8: the QLoRA-style configuration) and rank-r factors on
chosen linears are trained, so the optimizer's moments cover the factors
only. The adapters run unmerged, ``y += (x @ a) @ (b * scale)`` beside the
frozen product (``ops.common.linear``; ``materialize_weight`` for the
consumers that take whole weights, such as the fused tri-mul projections
and kernels K7/K8), so an int8 base is never dequantized into a copy.

Design: the adapters live in their own module, :class:`LoRA`, a sparse
mirror of the model keyed by the adapted linears' paths
(``layers.0.self_attn.q_proj.lora_a``), holding ``lora_a`` (d_in, r) and
``lora_b`` (r, d_out) as esm_tpu lays them out. :func:`patch` attaches the
factors and the scale to the targeted ``nn.Linear`` modules without copying
a weight; :func:`unpatch`, or leaving ``with patch(...)``, detaches them.
:func:`merge` folds trained factors into a copy of the base.

What differs from the JAX package: esm_tpu draws each adapted leaf's
``lora_a`` from its own split key; here one ``torch.Generator`` draws them
in esm_tpu's order of leaves (sorted paths; the layers that esm_tpu stacks
drawn as one (num_layers, d_in, r) tensor), so the bits differ and the
tests carry JAX's adapters across with ``io.from_jax.lora_from_jax``.
Targets are matched against esm_tpu's paths (``io.from_jax.jax_leaf``), so a
name set or a predicate selects the same linears in both packages.

Over a base sharded by ``parallel.sharding.shard_params`` the adapters stay
whole on every rank (esm_tpu's examples/pretrain_mlm.py:250-260 replicates
them on the mesh): they are drawn, checked and merged against the whole
weights' shapes, each layer's product uses this rank's part of them
(``parallel.tensor_parallel.gather_linear``), :func:`merge` adds each
rank's cut of the whole delta to its shard, and :func:`store_base` quantizes
each shard with the whole rows' scales. The families' linears (ESM-1's, the
MSA Transformer's axial projections) take their tp part alike. Over a
pipeline-sharded ESM-2 a rank holds the adapters of its stage's layers (and
of any targeted linear outside the layers): :func:`init_lora` draws every
layer's factors in the unsharded order and keeps its stage's, so a
pipelined run starts where one card's would; :func:`on_stage` cuts a whole
LoRA module to a stage. The stage's LoRA module carries the base's
``Sharding`` (``parallel.sharding``: the global norm counts each adapter
once over ``pp``; a checkpoint gathers them over ``pp``).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, FrozenSet, Iterator, List, Mapping, Tuple, Union

import torch
from torch import nn

from .io.from_jax import jax_leaf
from .parallel.sharding import _layer_of, sharding_of

# The LM families' hot linears: attention projections and the MLP.
DEFAULT_TARGETS: FrozenSet[str] = frozenset(
    {"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"}
)

Targets = Union[FrozenSet[str], set, Callable[[Tuple], bool]]

_INT8_MERGE = (
    "cannot merge LoRA into a weight-only int8 kernel: requantizing would "
    "perturb the frozen base. Run patched (unmerged), or dequantize the base "
    "to float and merge."
)


class Adapter(nn.Module):
    """The factors of one adapted linear: ``lora_a`` (d_in, r), ``lora_b``
    (r, d_out)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.lora_a = nn.Parameter(a)
        self.lora_b = nn.Parameter(b)


class LoRA(nn.Module):
    """The adapters of one model: an :class:`Adapter` at each adapted linear's
    path (plain ``nn.Module`` containers along the way), built from
    ``{path: (a, b)}``."""

    def __init__(self, factors: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        for path, (a, b) in factors.items():
            *parents, leaf = path.split(".")
            node = self
            for name in parents:
                if name not in node._modules:
                    node.add_module(name, nn.Module())
                node = node._modules[name]
            node.add_module(leaf, Adapter(a, b))

    def adapters(self) -> Iterator[Tuple[str, Adapter]]:
        return ((n, m) for n, m in self.named_modules() if isinstance(m, Adapter))


def fold_targets(path: Tuple) -> bool:
    """ESMFold's adapters: every linear of the trunk and the heads, none in
    the frozen LM (esm_tpu's example adapts every linear of the trainable
    subtree, ``targets=lambda path: True`` over ``split_fold_params``)."""
    return path[0] != "esm"


def _carry(lora: "LoRA", shard) -> "LoRA":
    """``lora`` carrying a pipeline-sharded base's Sharding (a stage's
    adapters): a copy sharing its process groups, with the factors' names
    added to its specs as replicated. Over any other base the adapters are
    whole on every rank."""
    if shard is not None and shard.stages > 1:
        carried = copy.copy(shard)
        carried.specs = {**shard.specs, **{name: () for name, _ in lora.named_parameters()}}
        lora.__dict__["_sharding"] = carried
    return lora


def on_stage(lora: "LoRA", model: nn.Module) -> "LoRA":
    """The adapters of a whole LoRA module (one card's, or a checkpoint's)
    that a rank of a pipeline-sharded ``model`` holds: its stage's layers'
    and those outside the layers, sharing their tensors, carrying the
    model's Sharding. Over any other model, ``lora`` itself."""
    shard = sharding_of(model)
    if shard is None or shard.stages == 1:
        return lora
    factors = {path: (a.lora_a.data, a.lora_b.data) for path, a in lora.adapters()
               if _layer_of(path) is None or _layer_of(path) in shard.layer_ids}
    return _carry(LoRA(factors), shard)


def _whole_shape(shard, name: str, weight: torch.Tensor) -> Tuple[int, ...]:
    """The whole (out, in) shape of the linear ``name``'s weight (a sharded
    model holds a shard of it)."""
    return tuple(weight.shape) if shard is None else shard.whole_shape(f"{name}.weight",
                                                                      weight.shape)


def _wants(targets: Targets, path: Tuple) -> bool:
    if callable(targets):
        return bool(targets(path))
    return path[-1] in targets


@torch.no_grad()
def init_lora(
    generator: torch.Generator,
    model: nn.Module,
    *,
    rank: int,
    targets: Targets = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> LoRA:
    """Adapters for every ``nn.Linear`` of ``model`` whose esm_tpu path
    matches ``targets`` (a name set tested against the last path element, or
    a predicate on the path tuple): ``lora_a`` ~ N(0, 1/d_in), ``lora_b`` = 0,
    so the patched model equals the base at step 0. ``generator`` lives on
    the model's device."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    shard = sharding_of(model)
    groups = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Linear):
            path, layer = jax_leaf(name)
            if _wants(targets, path):
                groups.setdefault(path, []).append((layer, name, module))
    if not groups:
        raise ValueError(
            "no linear nodes matched the LoRA targets "
            f"{targets if not callable(targets) else '<predicate>'}"
        )
    # over a pipeline, a stacked leaf is drawn for every stage's layers and
    # each of this stage's takes its own layer's slice
    staged = shard is not None and shard.stages > 1
    factors = {}
    for path in sorted(groups):  # esm_tpu's traversal: sorted keys, list order
        members = sorted(groups[path], key=lambda m: m[0] or 0)
        d_out, d_in = _whole_shape(shard, members[0][1], members[0][2].weight)
        device = members[0][2].weight.device
        stacked = members[0][0] is not None
        lead = ((model.cfg.num_layers if staged else len(members)),) if stacked else ()
        a = torch.randn((*lead, d_in, rank), generator=generator, dtype=dtype,
                        device=device) / math.sqrt(d_in)
        for i, (layer, name, _) in enumerate(members):
            factors[name] = ((a[layer if staged else i] if stacked else a).clone(),
                             torch.zeros((rank, d_out), dtype=dtype, device=device))
    order = {name: i for i, (name, _) in enumerate(model.named_modules())}
    return _carry(LoRA(dict(sorted(factors.items(), key=lambda kv: order[kv[0]]))), shard)


def _resolve(model: nn.Module, lora: LoRA) -> List[Tuple[nn.Linear, Adapter]]:
    """The (linear, adapter) pairs, checked before anything is attached."""
    shard = sharding_of(model)
    pairs = []
    for path, adapter in lora.adapters():
        try:
            layer = model.get_submodule(path)
        except AttributeError:
            raise KeyError(f"adapter path {path!r} not in the model") from None
        if not isinstance(layer, nn.Linear):
            raise ValueError(f"adapter {path!r} does not align with a linear")
        d_out, d_in = _whole_shape(shard, path, layer.weight)
        a, b = adapter.lora_a, adapter.lora_b
        if a.dim() != 2 or a.shape[0] != d_in or b.shape != (a.shape[1], d_out):
            raise ValueError(
                f"adapter {path!r} ({tuple(a.shape)}, {tuple(b.shape)}) does not align with "
                f"a linear of {d_in} -> {d_out}")
        pairs.append((layer, adapter))
    return pairs


class _Patched:
    """What :func:`patch` returns: leaving ``with`` detaches the adapters."""

    def __init__(self, model: nn.Module):
        self.model = model

    def __enter__(self) -> nn.Module:
        return self.model

    def __exit__(self, *exc) -> None:
        unpatch(self.model)


def patch(model: nn.Module, lora: LoRA, *, scale: float = 1.0) -> _Patched:
    """Attach each adapter's factors and ``scale`` (the LoRA alpha / rank) to
    its linear in ``model``, in place, copying no weight; returns a context
    manager that detaches them. Raises, attaching nothing, when an adapter
    has no linear of its shape in ``model``."""
    for layer, adapter in _resolve(model, lora):
        layer.lora = (adapter.lora_a, adapter.lora_b, scale)
    return _Patched(model)


def unpatch(model: nn.Module) -> nn.Module:
    """Detach every adapter that :func:`patch` attached to ``model``."""
    for module in model.modules():
        module.__dict__.pop("lora", None)
    return model


@torch.no_grad()
def merge(model: nn.Module, lora: LoRA, *, scale: float = 1.0) -> nn.Module:
    """A copy of ``model`` with the adapters folded into its weights:
    ``weight += scale * (a @ b)ᵀ``, accumulated in fp32 and cast back to the
    weight's dtype; it runs at the base model's cost. ``model`` is left as it
    is. A weight-only int8 weight is refused (merging would requantize the
    frozen base): run such a base patched. A sharded base gives a model
    sharded alike (the same ``Sharding``): each rank adds its cut of the
    whole delta to its shard, so its whole state is the unsharded merge's
    (over a pipeline, ``lora`` is the stage's: :func:`on_stage`)."""
    pairs = _resolve(model, lora)
    if any(layer.weight.dtype == torch.int8 for layer, _ in pairs):
        raise ValueError(_INT8_MERGE)
    shard = sharding_of(model)
    # the copy shares the Sharding: its process groups are not copied
    merged = unpatch(copy.deepcopy(model, {} if shard is None else {id(shard): shard}))
    for path, adapter in lora.adapters():
        w = merged.get_submodule(path).weight
        delta = torch.matmul(adapter.lora_a.float(), adapter.lora_b.float()).t()
        if shard is not None:
            delta = shard.cut(f"{path}.weight", delta)
        w.copy_((w.float() + scale * delta).to(w.dtype))
    return merged


@torch.no_grad()
def store_base(model: nn.Module, *, int8: bool = False) -> nn.Module:
    """The frozen base of esm_tpu's LoRA recipe (examples/pretrain_mlm.py
    --lora), in place: every fp32 parameter cast to bf16, or with ``int8``
    the linears' weights quantized to weight-only int8 from the fp32 values
    (``quantization.quantize_params``; the other parameters stay fp32; on a
    sharded model each shard with the whole rows' scales). Returns
    ``model``."""
    if int8:
        from .quantization import quantize_params

        return quantize_params(model)
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


def num_params(lora: LoRA) -> int:
    """Trainable adapter parameters (what the optimizer state covers)."""
    return sum(p.numel() for p in lora.parameters())
