"""The collectives of parameter sharding, as autograd Functions.

esm_tpu expresses tensor parallelism and ZeRO-3 as shardings and lets XLA's
SPMD partitioner insert the collectives. The port calls its layers
functionally, so the collectives are written out here, each with the
backward that makes the sharded step's gradients those of the whole batch:

  * :func:`gather_param`: the fsdp gather of a parameter before its layer
    runs. Forward ``all_gather_into_tensor`` over ``fsdp`` of the shard
    cast to the compute dtype (an fp32 master moves as bf16 under bf16
    compute: the product would cast it anyway); backward
    ``reduce_scatter_tensor`` of the gradient in the parameter's own dtype:
    every fsdp rank ran its own rows, so the gradients of the whole weight
    add up over the group, in fp32 for an fp32 master, and each rank keeps
    its shard's sum. Under remat the gather runs again in the recompute.
  * :func:`copy_to_tp` and :func:`reduce_from_tp`: Megatron's two operators
    over ``tp``. The first is the identity forward and an all-reduce
    backward, in front of the column-parallel products (each tp rank's
    columns give only part of the input's gradient); the second is an
    all-reduce forward and the identity backward, after the row-parallel
    products (out_proj, fc2) and the tied LM head's partial logits.
  * :func:`gather_from_tp`: an all-gather forward, this rank's block of the
    gradient backward: for values that every tp rank then uses alike (the
    embedding's features, the attention maps' heads, the LM head's dense
    weight), so the gradient arriving on each rank is the same.

A ``group`` of None is a mesh dimension of size 1: every function is then
the identity, so a mesh of one rank computes exactly what the unsharded
model computes. Gathers concatenate along ``dim``.

LoRA factors attached to a sharded linear (esm_tpu_torch/lora.py) are
whole on every rank; :func:`gather_linear` hands the product this tp
rank's part of them (``lora_tp``), so the adapter term is split as the
product is and its gradient on each rank is that rank's part.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.common import linear


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim``, in group rank
    order (not differentiable)."""
    n = _size(group)
    if n == 1:
        return x
    piece = x.movedim(dim, 0).contiguous()
    out = piece.new_empty((n * piece.shape[0],) + piece.shape[1:])
    dist.all_gather_into_tensor(out, piece, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the group
    (not differentiable)."""
    n = _size(group)
    if n == 1:
        return x
    whole = x.movedim(dim, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // n,) + whole.shape[1:])
    dist.reduce_scatter_tensor(out, whole, group=group)
    return out.movedim(0, dim)


def own_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (the group splits it evenly)."""
    n = _size(group)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[dist.get_rank(group)]


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dtype):
        ctx.dim, ctx.group, ctx.dtype = dim, group, x.dtype
        return all_gather(x.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.to(ctx.dtype), ctx.dim, ctx.group), None, None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return own_block(grad, ctx.dim, ctx.group).contiguous(), None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_param(p: torch.Tensor, dim: int, group, dtype: Optional[torch.dtype] = None,
                 ) -> torch.Tensor:
    """ZeRO-3's gather of a parameter sharded along ``dim``, moved as
    ``dtype`` when it is floating (backward: reduce-scatter of its gradient
    in ``p``'s dtype)."""
    if _size(group) == 1:
        return p
    dtype = dtype if dtype is not None and p.is_floating_point() else p.dtype
    return _GatherParam.apply(p, dim, group, dtype)


def gather_from_tp(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` (backward: this rank's block)."""
    return x if _size(group) == 1 else _GatherFromTP.apply(x, dim, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward."""
    return x if _size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return x if _size(group) == 1 else _ReduceFromTP.apply(x, group)


def row_parallel_linear(layer, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(layer, x)`` for a row-parallel layer whose weight holds this
    tp rank's input columns: the partial products (with a LoRA term over
    this rank's rows of ``a``, which ``gather_linear`` cut) are all-reduced,
    then the (replicated) bias is added once. With no tp group, ``linear``
    itself."""
    if _size(group) == 1:
        return linear(layer, x)
    bare = SimpleNamespace(weight=layer.weight, bias=None)
    if layer.weight.dtype == torch.int8:
        bare.scale = layer.scale
    if getattr(layer, "lora", None) is not None:
        bare.lora = layer.lora
    y = reduce_from_tp(linear(bare, x), group)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


def gather_linear(layer, dim: int, group, tp_group: Optional[object] = None,
                  tp_dim: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                  lora_tp: Optional[object] = None, lora_dim: int = 1):
    """A stand-in for ``layer`` (weight, bias, int8 scale, LoRA factors) whose
    weight is gathered over ``group`` along ``dim`` (ZeRO-3; moved as
    ``dtype``, the compute dtype the product casts it to) and, with
    ``tp_group``, over tp along ``tp_dim`` for a replicated product (its bias
    too; the LoRA term is then the whole one on every tp rank). With
    ``lora_tp``, the tp group of a split product, the factors are cut to
    this rank's part: ``lora_dim`` 1, a column-parallel product, keeps its
    output columns of ``b``; 0, a row-parallel one, its input rows of ``a``
    (differentiable cuts: the other blocks get zero gradients)."""
    w = gather_param(layer.weight, dim, group, dtype)
    b = layer.bias
    if tp_group is not None:
        w = gather_from_tp(w, tp_dim, tp_group)
        if b is not None:
            b = gather_from_tp(b, 0, tp_group)
    out = SimpleNamespace(weight=w, bias=b)
    if layer.weight.dtype == torch.int8:
        out.scale = layer.scale
    lora = layer.__dict__.get("lora")
    if lora is not None:
        a, b_lora, scale = lora
        if lora_dim == 1:
            b_lora = own_block(b_lora, 1, lora_tp)
        else:
            a = own_block(a, 0, lora_tp)
        out.lora = (a, b_lora, scale)
    return out
