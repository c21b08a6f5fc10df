"""Parameter sharding of the language models over the (data, fsdp, tp) mesh.

Port of esm_tpu/parallel/sharding.py. The placement rules are esm_tpu's
(``spec_for_param`` :43): Megatron tensor parallelism over ``tp`` and
ZeRO-3 over ``fsdp``:

  * q/k/v and fc1 are column-parallel: their outputs over ``tp``, their
    inputs over ``fsdp`` (gathered per layer before it runs);
  * out_proj and fc2 are row-parallel: their inputs over ``tp`` (partial
    sums all-reduced), their outputs over ``fsdp``;
  * the token embedding holds its features over ``tp`` (the tied LM head
    contracts over them, so its partial logits are all-reduced);
  * the LM head's dense layer is column-parallel;
  * norms, the contact head and the row-parallel biases are replicated;
    int8 ``scale``s follow the bias rules;
  * ESM-1's bias_kv row (``bias_k``, ``bias_v``) holds its features over
    ``tp``, as the keys and values it joins do (esm_tpu replicates it: see
    ROADMAP Queue 3, "Deliberate divergences"); ESM-1's untied ``embed_out``
    and its bias, the positional embeddings and the MSA Transformer's
    ``msa_position_embedding`` are replicated;
  * activations: the batch over (data, fsdp); the tp ranks hold the same
    rows and all of T (:func:`batch_rows`).

The port's ``nn.Linear.weight`` is (out, in), the transpose of esm_tpu's
(in, out) ``kernel``: esm_tpu's (fsdp, tp) is (tp, fsdp) here. A spec names,
per dimension of the port's tensor, the mesh axis it is split over (or None).

:func:`shard_params` keeps on each rank only its shard of every parameter,
so its resident bytes are what ``memory_plan.plan`` charges. A sharded
model carries its :class:`Sharding`, which ``esm2.apply``, the layers and
the training step read; the collectives are in ``tensor_parallel``. With
a four-axis mesh whose outermost axis is ``pp`` (``pipeline.make_pp_mesh``)
the layers are split into stages as well: a rank keeps its stage's layers
only. The families: ESM-2, ESM-1/1b/1v (``models.esm1``) and the MSA
Transformer (``models.msa_transformer``, whose axial layers run row and
column attention on a tp rank's heads); esm_tpu pipelines ESM-2 only
(``esm2.apply_pipelined``), so a ``pp`` mesh takes ESM-2 only.

Shards must be even: a dimension that the mesh axes do not divide is
refused, so every ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
sees equal pieces and the plan's bytes are exact.

LoRA over a sharded base (esm_tpu's examples/pretrain_mlm.py:240-262): the
adapters stay whole on every rank, the base is never gathered whole. A
layer's stand-in (:meth:`Sharding.gather_layer`) carries the factors: a
column-parallel product adds ``(x @ a) @ b[:, this tp rank's outputs]``, a
row-parallel one ``(x_local @ a[this tp rank's inputs]) @ b`` to its
partial sum before the tp all-reduce. Each rank's adapter gradient is then
its part of the whole batch's; :meth:`Sharding.sync_adapter_grads` sums
them. Over a pipeline-sharded base a rank holds the adapters of its
stage's layers (and those outside the layers), and the LoRA module carries
the base's :class:`Sharding`: their gradients come from the stage's
backward, their global norm counts each once over ``pp``, and a checkpoint
gathers them over ``pp`` as it gathers the base's layers. An entry the
specs do not name (an adapter) is replicated.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import tensor_parallel as tpar
from .mesh import AXES, AXIS_DATA, AXIS_FSDP, AXIS_TP

AXIS_PP = "pp"
COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1")
ROW_PARALLEL = ("out_proj", "fc2")

Spec = Tuple[Optional[str], ...]


def spec_for(name: str, ndim: int) -> Spec:
    """The spec of one state-dict entry (parameter or int8 scale), by name."""
    parts = name.split(".")
    leaf = parts[-1]
    replicated = (None,) * ndim
    if "embed_tokens" in parts or name == "lm_head.weight":  # the tied projection
        return (None, AXIS_TP)
    if leaf in ("bias_k", "bias_v"):  # ESM-1's (1, 1, D) key/value row: K/V's heads
        return (None, None, AXIS_TP)
    owner = next((p for p in parts if p in COLUMN_PARALLEL + ROW_PARALLEL), None)
    if owner in COLUMN_PARALLEL:
        return (AXIS_TP, AXIS_FSDP) if leaf == "weight" else (AXIS_TP,)
    if owner in ROW_PARALLEL:
        return (AXIS_FSDP, AXIS_TP) if leaf == "weight" else replicated
    if parts[0] == "lm_head" and "dense" in parts:
        # esm_tpu replicates the dense layer's int8 scale (no rule names it)
        return {"weight": (AXIS_TP, AXIS_FSDP), "bias": (AXIS_TP,)}.get(leaf, replicated)
    return replicated


def _sharded_entries(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors a sharded model splits: its parameters (the tied
    projection once) and its int8 scales, by state-dict name; not the
    rotary ``inv_freq`` buffers (replicated, and not parameters in esm_tpu)."""
    out = dict(model.named_parameters())
    for name, buf in model.named_buffers():
        if name.rpartition(".")[2].endswith("scale"):
            out[name] = buf
    return out


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """Spec of every parameter and int8 scale of ``model``, by state-dict name."""
    return {name: spec_for(name, t.dim()) for name, t in _sharded_entries(model).items()}


def shard_factor(spec: Spec, sizes: Dict[str, int]) -> int:
    n = 1
    for axis in spec:
        if axis is not None:
            n *= sizes.get(axis, 1)
    return n


def _check_family(model, mesh) -> None:
    from ..models import esm1, esm2, msa_transformer

    if not isinstance(model, (esm2.ESM2, esm1.ESM1, msa_transformer.MSATransformer)):
        raise TypeError(f"parameter sharding takes ESM-2, ESM-1/1b/1v or the MSA Transformer, "
                        f"not {type(model).__name__}")
    if AXIS_PP in tuple(mesh.mesh_dim_names) and not isinstance(model, esm2.ESM2):
        raise ValueError(f"a pipeline ('pp') mesh takes ESM-2 only, not {type(model).__name__}: "
                         "esm_tpu pipelines ESM-2 alone (esm2.apply_pipelined); shard the model "
                         "over a (data, fsdp, tp) mesh")


def _layer_of(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "layers" else None


class Elsewhere(nn.Module):
    """The place of a layer that another pipeline stage holds."""


class Sharding:
    """A sharded model's place on the mesh: each axis's process group (None
    for an axis of size 1), size and this rank's coordinate; the combined
    (data, fsdp) group of the batch rows; the specs; with a ``pp`` axis the
    stage this rank runs and its layers. Every rank of the mesh must build
    it at the same time (it creates process groups)."""

    def __init__(self, mesh, specs: Dict[str, Spec], num_layers: int):
        names = tuple(mesh.mesh_dim_names)
        if names not in (AXES, (AXIS_PP,) + AXES):
            raise ValueError(f"a sharding mesh has axes {AXES} (optionally 'pp' first): {names}")
        self.mesh = mesh
        self.specs = specs
        self.sizes = {a: mesh.size(i) for i, a in enumerate(names)}
        self.coords = {a: mesh.get_local_rank(a) for a in names}
        self.group = {a: mesh.get_group(a) if self.sizes[a] > 1 else None for a in names}
        self.group["dp"] = self._rows_group(mesh, names)
        self.stages = self.sizes.get(AXIS_PP, 1)
        self.layer_ids = stage_layers(num_layers, self.stages, self.coords.get(AXIS_PP, 0))

    @staticmethod
    def _rows_group(mesh, names):
        """The process group over (data, fsdp) that holds this rank (every
        rank creates every such group, as new_group requires)."""
        data, fsdp = mesh.size(names.index(AXIS_DATA)), mesh.size(names.index(AXIS_FSDP))
        if data == 1 or fsdp == 1:
            return mesh.get_group(AXIS_FSDP if data == 1 else AXIS_DATA) if data * fsdp > 1 \
                else None
        ranks = mesh.mesh
        order = [names.index(a) for a in names if a not in (AXIS_DATA, AXIS_FSDP)]
        ranks = ranks.permute(*order, names.index(AXIS_DATA), names.index(AXIS_FSDP))
        mine = None
        for row in ranks.reshape(-1, data * fsdp).tolist():
            group = dist.new_group(row)
            if dist.get_rank() in row:
                mine = group
        return mine

    @property
    def tp(self):
        return self.group[AXIS_TP]

    @property
    def fsdp(self):
        return self.group[AXIS_FSDP]

    def axes_of(self, name: str):
        """The mesh axes ``name`` is split over (``pp`` for a stage's layer)."""
        axes = {a for a in self.specs[name] if a is not None}
        if self.stages > 1 and _layer_of(name) is not None:
            axes.add(AXIS_PP)
        return axes

    def counts_once(self, name: str) -> bool:
        """Whether this rank is the one copy of ``name``'s shard that a sum
        over the mesh counts: coordinate 0 on every axis it is replicated over."""
        axes = self.axes_of(name)
        return all(self.coords[a] == 0 for a in self.coords if a not in axes)

    # -- the pieces ---------------------------------------------------------

    def whole_shape(self, name: str, shape, spec: Optional[Spec] = None) -> Tuple[int, ...]:
        """The whole shape of entry ``name`` (or of a tensor laid out by
        ``spec``) from a shard's ``shape``."""
        spec = self.specs[name] if spec is None else spec
        return tuple(n * (self.sizes[a] if a is not None else 1)
                     for n, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))

    def cut(self, name: str, full: torch.Tensor, spec: Optional[Spec] = None) -> torch.Tensor:
        """This rank's shard of the whole tensor ``full`` of entry ``name``
        (laid out by ``spec`` when given, e.g. an optimizer statistic)."""
        out = full
        for dim, axis in enumerate(self.specs[name] if spec is None else spec):
            if axis is None or self.sizes[axis] == 1:
                continue
            n = self.sizes[axis]
            if out.shape[dim] % n:
                raise ValueError(
                    f"{name}: dimension {dim} of size {full.shape[dim]} does not split evenly "
                    f"over the {axis!r} axis of size {n}")
            out = out.chunk(n, dim=dim)[self.coords[axis]]
        return out.contiguous()

    def whole(self, name: str, local: torch.Tensor, spec: Optional[Spec] = None) -> torch.Tensor:
        """The whole tensor of entry ``name`` (laid out by ``spec`` when
        given) from every rank's shard, a new tensor (every rank of the mesh
        calls it; not differentiable)."""
        out = local
        for dim, axis in enumerate(self.specs[name] if spec is None else spec):
            if axis is not None:
                out = tpar.all_gather(out, dim, self.group[axis])
        return local.clone() if out is local else out.contiguous()

    # -- the layers ---------------------------------------------------------

    def gather_layer(self, layer, dtype: Optional[torch.dtype] = None):
        """A stand-in for ``layer`` (a ``TransformerLayer``, or the MSA
        Transformer's ``AxialTransformerLayer``) whose weights are gathered
        over fsdp (ZeRO-3; their tp shards stay) as ``dtype``, the compute
        dtype: column-parallel weights along their input dimension,
        row-parallel ones along their output dimension. ESM-1's bias_kv row
        comes as this tp rank's features; LayerNorms as they are."""
        from types import SimpleNamespace

        g = self.fsdp

        # LoRA factors: a column-parallel product keeps this tp rank's
        # outputs of b, a row-parallel one its inputs of a
        def column(lin):
            return tpar.gather_linear(lin, 1, g, dtype=dtype, lora_tp=self.tp, lora_dim=1)

        def row(lin):
            return tpar.gather_linear(lin, 0, g, dtype=dtype, lora_tp=self.tp, lora_dim=0)

        def attention(attn):
            out = SimpleNamespace(q_proj=column(attn.q_proj), k_proj=column(attn.k_proj),
                                  v_proj=column(attn.v_proj), out_proj=row(attn.out_proj))
            for name in ("bias_k", "bias_v"):
                if hasattr(attn, name):
                    setattr(out, name, getattr(attn, name))
            return out

        if hasattr(layer, "row_self_attention"):  # an axial layer: three residual blocks
            def block(residual, body):
                return SimpleNamespace(layer=body, layer_norm=residual.layer_norm)

            ffn = layer.feed_forward_layer
            return SimpleNamespace(
                row_self_attention=block(layer.row_self_attention,
                                         attention(layer.row_self_attention.layer)),
                column_self_attention=block(layer.column_self_attention,
                                            attention(layer.column_self_attention.layer)),
                feed_forward_layer=block(ffn, SimpleNamespace(fc1=column(ffn.layer.fc1),
                                                              fc2=row(ffn.layer.fc2))))
        return SimpleNamespace(
            self_attn=attention(layer.self_attn),
            self_attn_layer_norm=layer.self_attn_layer_norm,
            fc1=column(layer.fc1),
            fc2=row(layer.fc2),
            final_layer_norm=layer.final_layer_norm,
        )

    # -- the gradients ------------------------------------------------------

    def sync_grads(self, model: nn.Module) -> None:
        """Make every parameter's ``.grad`` its shard of the whole batch's
        gradient: the fsdp-sharded weights were reduce-scattered over fsdp by
        their gathers' backward and are all-reduced over data; the others
        over (data, fsdp); the parameters every pipeline stage holds over pp
        too (each stage's share of their gradient: the embedding's input on
        the first, the head on the last). A parameter without a gradient
        takes zeros, so every rank issues the same collectives."""
        def groups(name):
            axes = self.axes_of(name)
            out = [self.group[AXIS_DATA] if AXIS_FSDP in axes else self.group["dp"]]
            if self.stages > 1 and AXIS_PP not in axes:
                out.append(self.group[AXIS_PP])
            return out

        _sum_grads((p, groups(name)) for name, p in model.named_parameters() if p.requires_grad)

    def sync_adapter_grads(self, adapters: nn.Module) -> None:
        """Make every adapter's ``.grad`` (adapters whole on every rank, over
        this sharded base; over a pipeline, a stage's layers' adapters on
        that stage's ranks) the whole batch's gradient: summed over the
        (data, fsdp) rows, over tp where the adapted product is split over
        tp (each tp rank holds its block's or its partial sum's part; a
        product every tp rank runs alike counts once), and for an adapter
        outside the layers over pp, as :meth:`sync_grads` sums the
        parameters every stage holds. An adapter without a gradient takes
        zeros, so every rank issues the same collectives."""
        for path, adapter in adapters.adapters():
            split = any(part in COLUMN_PARALLEL + ROW_PARALLEL for part in path.split("."))
            groups = [self.group["dp"], self.tp if split else None]
            if self.stages > 1 and _layer_of(path) is None:
                groups.append(self.group[AXIS_PP])
            _sum_grads((p, groups) for p in (adapter.lora_a, adapter.lora_b))

    def norm_sq(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """sum over the whole model of sum(t * t), each shard once: the
        copies of replicated entries count on one rank only (a stage's
        layers' adapters on one rank of their stage)."""
        total = sum(torch.sum(t * t) if self.counts_once(name) else torch.zeros_like(t.sum())
                    for name, t in tensors.items())
        if dist.get_world_size() > 1:
            dist.all_reduce(total)
        return total


def _sum_grads(items) -> None:
    """All-reduce each parameter's ``.grad`` (zeros where it has none, so
    every rank issues the same collectives) over each of its groups (None:
    an axis of size 1), the last sum of each asynchronously."""
    works = []
    for p, groups in items:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        groups = [g for g in groups if g is not None]
        for group in groups[:-1]:  # the last sum reads the earlier ones
            dist.all_reduce(p.grad, group=group)
        if groups:
            works.append(dist.all_reduce(p.grad, group=groups[-1], async_op=True))
    for work in works:
        work.wait()


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    """The layers of pipeline stage ``stage`` of ``stages``: L/S each, in order."""
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible by {stages} stages")
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def sharding_of(model: nn.Module) -> Optional[Sharding]:
    """The :class:`Sharding` of a sharded model, or None."""
    return model.__dict__.get("_sharding")


@torch.no_grad()
def _shard_module(module: nn.Module, prefix: str, sharding: Sharding, dtype,
                  skip: Optional[str] = None) -> None:
    """Replace each parameter's and int8 scale's data of ``module`` (whose
    names in the model start with ``prefix``) by this rank's shard; names
    that start with ``skip`` are left as they are."""
    for name, p in list(module.named_parameters(recurse=True)):
        if skip is not None and name.startswith(skip):
            continue
        local = sharding.cut(prefix + name, p.data)
        if dtype is not None and local.is_floating_point():
            local = local.to(dtype)
        p.data = local
    for name, buf in list(module.named_buffers(recurse=True)):
        full = prefix + name
        if full in sharding.specs and not (skip is not None and name.startswith(skip)):
            owner, _, attr = name.rpartition(".")
            target = module.get_submodule(owner) if owner else module
            target._buffers[attr] = sharding.cut(full, buf)


def shard_params(model_or_parts, mesh, *, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Keep on this rank only its shard of every parameter of a language
    model and attach the :class:`Sharding` (every rank of ``mesh`` calls it
    alike).

    ``model_or_parts``: a whole ``esm2.ESM2``, ``esm1.ESM1`` or
    ``msa_transformer.MSATransformer``, or a layer-at-a-time builder as
    ``esm2.init_parts``, ``esm1.init_parts`` and
    ``examples.esm2_15b_int8_single_chip.seeded_parts`` yield one: (cfg, the
    shell without layers), then each layer. Each layer is cut as soon as it arrives, and the shell when the
    builder has ended (``init_parts`` fills its head last), so no rank ever
    holds more than the shell and one whole layer; with a ``pp`` axis (ESM-2
    only), the layers of other stages are dropped. ``dtype`` casts the floating
    shards (e.g. ``torch.bfloat16`` for a bf16 forward). Returns the model."""
    if isinstance(model_or_parts, nn.Module):
        model, layers = model_or_parts, None
    else:
        parts = iter(model_or_parts)
        cfg, model = next(parts)
        layers = parts
    _check_family(model, mesh)
    cfg = model.cfg
    sharding = Sharding(mesh, param_specs(model), cfg.num_layers)
    if cfg.attention_heads % sharding.sizes[AXIS_TP]:
        raise ValueError(f"{cfg.attention_heads} attention heads do not split evenly over the "
                         f"'tp' axis of size {sharding.sizes[AXIS_TP]}")
    if layers is None:
        for i, layer in enumerate(model.layers):
            if i not in sharding.layer_ids:
                model.layers[i] = Elsewhere()
        _shard_module(model, "", sharding, dtype)
    else:
        for i, layer in enumerate(layers):
            if i not in sharding.layer_ids:
                model.layers.append(Elsewhere())
                continue
            prefix = f"layers.{i}."
            sharding.specs.update(
                {prefix + n: s for n, s in param_specs(layer).items()})
            _shard_module(layer, prefix, sharding, dtype)
            model.layers.append(layer)
        if len(model.layers) != cfg.num_layers:
            raise ValueError(f"the builder gave {len(model.layers)} layers, the config "
                             f"{cfg.num_layers}")
        _shard_module(model, "", sharding, dtype, skip="layers.")
    model.__dict__["_sharding"] = sharding
    return model


def batch_rows(x: torch.Tensor, sharding_or_mesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a full batch that every rank holds: rows over
    (data, fsdp), the data coordinate outermost; the tp (and pp) ranks hold
    the same rows and the whole of T (``mesh.local_shard`` splits T: that is
    the ring's layout, not this one)."""
    s = sharding_or_mesh
    if isinstance(s, Sharding):
        data, fsdp = s.sizes[AXIS_DATA], s.sizes[AXIS_FSDP]
        row = s.coords[AXIS_DATA] * fsdp + s.coords[AXIS_FSDP]
    else:
        data, fsdp = s.size(s.mesh_dim_names.index(AXIS_DATA)), s.size(
            s.mesh_dim_names.index(AXIS_FSDP))
        row = s.get_local_rank(AXIS_DATA) * fsdp + s.get_local_rank(AXIS_FSDP)
    n = data * fsdp
    if x.shape[dim] % n:
        raise ValueError(f"batch {x.shape[dim]} is not divisible by the {n} row shards "
                         f"(data x fsdp) of the mesh")
    return x.chunk(n, dim=dim)[row] if n > 1 else x


def dp_sum(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``t`` summed over the (data, fsdp) ranks, in place."""
    if sharding.group["dp"] is not None:
        dist.all_reduce(t, group=sharding.group["dp"])
    return t


def _key(name: str) -> str:
    """The sharding's entry of a state-dict name (the tied LM-head projection
    is the embedding)."""
    return "embed_tokens.weight" if name == "lm_head.weight" else name


def whole_names(sharding: Sharding, names) -> Iterator[Tuple[str, str, int]]:
    """(whole name, this rank's name of the same entry, the pipeline stage
    that holds it) for each entry of the whole model, in the model's order,
    from the names of this rank's tensors (``names``, keyed like its state
    dict or parameters): with a ``pp`` axis, this stage's layers stand for
    every stage's (each holds L/S layers of one structure)."""
    names = list(names)
    per = len(sharding.layer_ids)
    first = sharding.layer_ids.start
    stage = sharding.coords.get(AXIS_PP, 0)
    layers_done = False
    for name in names:
        i = _layer_of(name)
        if i is None or sharding.stages == 1:
            yield name, name, stage
            continue
        if layers_done:
            continue
        layers_done = True
        suffixes = [n.split(".", 2)[2] for n in names if _layer_of(n) == first]
        for layer in range(per * sharding.stages):
            for suffix in suffixes:
                yield (f"layers.{layer}.{suffix}", f"layers.{first + layer % per}.{suffix}",
                       layer // per)


def iter_whole_state(model: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None,
                     specs: Optional[Dict[str, Spec]] = None):
    """(name, whole tensor) of each entry of a sharded model's state dict (or
    of ``tensors``, keyed like its parameters, e.g. optimizer moments, laid
    out by ``specs`` where given), one entry at a time, gathered over the
    mesh onto the shards' device: a caller that lets each go before taking
    the next holds one whole entry at a time. Every rank iterates it alike.
    With a ``pp`` axis, each stage's layers are gathered within the stage
    and broadcast over pp, so every rank gets the whole model's entries."""
    sharding = sharding_of(model)
    source = model.state_dict() if tensors is None else tensors
    specs = specs or {}
    stage = sharding.coords.get(AXIS_PP, 0)
    for name, local_name, owner in whole_names(sharding, source):
        t = source[local_name].detach()
        key, spec = _key(local_name), specs.get(local_name)
        sharded = spec is not None or key in sharding.specs
        if owner == stage:
            out = sharding.whole(key, t, spec) if sharded else t.clone()
        else:  # another stage's layer: its shape is this stage's counterpart's
            shape = sharding.whole_shape(key, t.shape, spec) if sharded else t.shape
            out = t.new_empty(shape)
        if sharding.stages > 1 and _layer_of(name) is not None:  # one stage's: to every stage
            group = sharding.group[AXIS_PP]
            dist.broadcast(out, src=dist.get_global_rank(group, owner), group=group)
        yield name, out
        del out  # before the next entry is gathered


def whole_state(model: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None,
                specs: Optional[Dict[str, Spec]] = None) -> Dict[str, torch.Tensor]:
    """:func:`iter_whole_state` as one dict: every whole entry at once, on
    every rank (for a small model; a checkpoint gathers one at a time)."""
    return dict(iter_whole_state(model, tensors, specs))


def _check_names(sharding: Sharding, own, given) -> None:
    want = [name for name, _, _ in whole_names(sharding, own)]
    if set(want) != set(given):
        missing, extra = set(want) - set(given), set(given) - set(want)
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, unexpected "
                       f"{sorted(extra)}")


@torch.no_grad()
def load_whole_state(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy a whole state dict (as saved from any mesh, or unsharded) into a
    sharded model: each rank takes its shard (with a ``pp`` axis, of its
    stage's layers). ``state`` may be any mapping whose entries are read as
    they are needed. Strict: the names must match."""
    sharding = sharding_of(model)
    own = model.state_dict()
    _check_names(sharding, own, state.keys())
    for name, dst in own.items():
        key = _key(name)
        src = state[name]
        dst.copy_(sharding.cut(key, src) if key in sharding.specs else src)
    return model


def cut_like(model: nn.Module, tensors: Mapping[str, torch.Tensor], own: Mapping[str, object],
             specs: Optional[Dict[str, Spec]] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, this rank's shard) for each name of ``own`` (this rank's
    tensors keyed like the model's parameters), cut from the whole tensors
    ``tensors`` (laid out by ``specs`` where given), one at a time. Strict:
    ``tensors`` names the whole model's entries."""
    sharding = sharding_of(model)
    _check_names(sharding, own, tensors.keys())
    specs = specs or {}
    for name in own:
        yield name, sharding.cut(name, tensors[name], specs.get(name))


def resident_bytes(model: nn.Module) -> int:
    """Bytes of the parameters and int8 scales this rank holds."""
    return sum(t.numel() * t.element_size() for t in _sharded_entries(model).values())
