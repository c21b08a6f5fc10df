"""Weight-only int8 quantization.

Port of esm_tpu/quantization.py: symmetric per-output-channel int8 for the
weights of the linear layers. ``ops.common.linear`` consumes the layout
(y = (x @ W_qᵀ) * scale + b): the int8 weight is cast to the activation
dtype inside the product, and the per-channel fp32 scales are applied
after it. The int8 values and scales equal esm_tpu's bit for bit: the
scale is max|W| / 127 in fp32, the values round half to even.

Embeddings, layer norms, biases and the tied LM-head projection keep their
dtype. ESM-1's untied ``embed_out`` is a linear kernel in esm_tpu's tree, so
it is selected like a linear (its scales in the ``embed_out_scale`` buffer).

What differs from the JAX package: it returns a new parameter tree; here
:func:`quantize_params` changes the modules in place (a handle's
``quantized()`` quantizes a copy). ``min_size`` counts a linear's elements
as esm_tpu does, over the whole leaf: the layers that esm_tpu stacks into
one (num_layers, in, out) kernel (``io.from_jax.jax_leaf``) are selected
together.

A model sharded by ``parallel.sharding.shard_params`` is quantized shard by
shard: a row's absmax is taken over the whole row (a max over the mesh axis
that splits the input dimension), the leaf sizes are the whole leaves', and
each rank keeps its shard of the whole scale vector, so the int8 values and
scales are those of the whole tree.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# Raw (out, in) parameters that esm_tpu keeps as linear kernels, and the
# buffer that holds their scales once quantized.
RAW_KERNELS = {"embed_out": "embed_out_scale"}


def quantize_weight(w: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (int8 values, fp32 scales (out,)):
    scale[o] = max|W[o, :]| / 127 (1 for an all-zero row), computed in fp32
    (a bf16 amax / 127 that rounds down would clip the row's largest weights).
    ``group``: the process group over which the rows' input columns are
    split (the max is then the whole row's)."""
    w = w.detach()
    amax = w.abs().amax(dim=1).float()
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w.float() / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_linear(layer: nn.Linear, group=None) -> nn.Linear:
    """In place: an int8 ``weight`` (requires_grad False) and an fp32
    ``scale`` buffer (out,); the bias is kept. ``group``: as for
    :func:`quantize_weight`."""
    q, scale = quantize_weight(layer.weight, group)
    layer.weight = nn.Parameter(q, requires_grad=False)
    layer.register_buffer("scale", scale)
    return layer


def _candidates(model: nn.Module) -> Dict[str, Tuple[nn.Module, str]]:
    """Name -> (module, parameter name) of every float (out, in) weight that
    esm_tpu treats as a linear kernel."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Linear) and module.weight.is_floating_point():
            out[name] = (module, "weight")
        for attr in RAW_KERNELS:
            p = module._parameters.get(attr)
            if p is not None and p.is_floating_point() and p.dim() == 2:
                out[f"{name}.{attr}" if name else attr] = (module, attr)
    return out


@torch.no_grad()
def quantize_params(
    model: nn.Module,
    *,
    min_size: int = 1 << 16,
    predicate: Optional[Callable[[str, nn.Module], bool]] = None,
) -> nn.Module:
    """Quantize, in place, every linear weight of ``model`` whose esm_tpu leaf
    holds at least ``min_size`` elements (tiny projections gain nothing and
    lose accuracy); ``predicate(name, module)`` overrides the selection.
    Returns ``model``."""
    from .io.from_jax import jax_leaf
    from .parallel.sharding import sharding_of

    shard = sharding_of(model)
    found = _candidates(model)
    leaf_size: Dict[tuple, int] = {}
    for name, (module, attr) in found.items():
        path = jax_leaf(name)[0]
        leaf_size[path] = leaf_size.get(path, 0) + _whole_numel(shard, name, module, attr)
    for name, (module, attr) in found.items():
        keep = (predicate(name, module) if predicate is not None
                else leaf_size[jax_leaf(name)[0]] >= min_size)
        if not keep:
            continue
        if shard is not None:
            _quantize_shard(shard, name, module)
        elif attr == "weight":
            quantize_linear(module)
        else:
            q, scale = quantize_weight(getattr(module, attr))
            setattr(module, attr, nn.Parameter(q, requires_grad=False))
            module.register_buffer(RAW_KERNELS[attr], scale)
    return model


def _whole_numel(shard, name: str, module: nn.Module, attr: str) -> int:
    """Elements of the candidate ``name``'s whole weight (with a ``pp`` axis,
    times the stages: every stage holds its share of a stacked leaf)."""
    from .parallel.sharding import _layer_of

    w = getattr(module, attr)
    if shard is None:
        return w.numel()
    return (math.prod(shard.whole_shape(f"{name}.weight", w.shape))
            * (shard.stages if _layer_of(name) is not None else 1))


def _quantize_shard(shard, name: str, module: nn.Linear) -> None:
    """Quantize this rank's shard of the linear ``name`` with the whole rows'
    scales, and keep its shard of the whole scale vector (its spec joins the
    sharding's)."""
    from .parallel.sharding import spec_for
    from .parallel.tensor_parallel import all_gather

    out_axis, in_axis = shard.specs[f"{name}.weight"]
    quantize_linear(module, shard.group[in_axis] if in_axis is not None else None)
    key = f"{name}.scale"
    shard.specs[key] = spec_for(key, 1)
    rows = module.scale if out_axis is None else all_gather(module.scale, 0, shard.group[out_axis])
    module.register_buffer("scale", shard.cut(key, rows))


@torch.no_grad()
def adopt_int8_layout(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """Give every linear weight of ``model`` that ``state_dict`` holds as int8
    (a quantized checkpoint, or esm_tpu's int8 tree carried across by
    ``io.from_jax``) the int8 layout, so that ``load_state_dict`` takes the
    state dict strictly. Returns ``model``."""
    for name, (module, attr) in _candidates(model).items():
        if state_dict.get(name if attr != "weight" else f"{name}.weight",
                          torch.empty(0)).dtype != torch.int8:
            continue
        p = getattr(module, attr)
        setattr(module, attr, nn.Parameter(torch.zeros(p.shape, dtype=torch.int8,
                                                       device=p.device), requires_grad=False))
        module.register_buffer("scale" if attr == "weight" else RAW_KERNELS[attr],
                               torch.ones(p.shape[0], device=p.device))
    return model


def param_bytes(model: nn.Module) -> int:
    """Bytes of the parameters and buffers (the int8 scales among them)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
