"""Save and restore parameters and whole training states with ``torch.save``.

Port of esm_tpu/io/checkpoint.py:17-90 for one device: the JAX package
writes orbax directories that restore onto a mesh; here a checkpoint is a
directory holding one ``torch.save`` file (``params.pt``, or
``train_state.pt`` for a full state), written to a temporary name and then
renamed, so an interrupted save leaves the previous file whole. Files are
read with ``weights_only=True``: they hold only tensors and numbers. A
released checkpoint in the reference's ``.pt`` layout is loaded by
``pretrained.load_model_and_alphabet`` (``--init-from``), not here.

A model sharded by ``parallel.sharding.shard_params`` saves the whole tree,
gathered over the mesh and written by rank 0 in the same layout (every
rank calls the save). The entries are gathered one at a time and rank 0
copies each to the host at once, so a card holds its shards and one whole
entry, never the whole tree; loading into a sharded model, or ``--resume``, cuts
each rank's shard from the whole tree, so a checkpoint moves between any
meshes, and to one device. A pipeline-sharded model is not saved (ROADMAP
Queue 1, item 13d).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..parallel.sharding import cut_like, iter_whole_state, load_whole_state, sharding_of

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"


def _save(obj, path: Path, sharded: bool = False) -> None:
    """Write ``obj``; on a sharded model's mesh rank 0 writes and every rank
    waits for it."""
    if not sharded or dist.get_rank() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, path)
    if sharded:
        dist.barrier()


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _whole(model: torch.nn.Module, tensors=None) -> Optional[Dict[str, torch.Tensor]]:
    """The whole tensors of ``model``'s state dict (or of ``tensors`` keyed
    like its parameters), on the CPU. A sharded model's are gathered one
    entry at a time, and only rank 0, which writes, keeps them: the other
    ranks get None."""
    if sharding_of(model) is None:
        return _cpu(model.state_dict() if tensors is None else tensors)
    if sharding_of(model).stages > 1:
        raise NotImplementedError("saving a pipeline-sharded model (ROADMAP Queue 1, item 13d)")
    keep = dist.get_rank() == 0
    out = {}
    for name, whole in iter_whole_state(model, tensors):
        if keep:
            out[name] = whole.to("cpu", copy=True)
        del whole  # before the next entry is gathered
    return out if keep else None


def save_params(path, model: torch.nn.Module) -> None:
    """Write ``model``'s state dict to ``<path>/params.pt`` (a sharded
    model's whole tree, by rank 0)."""
    _save(_whole(model), Path(path) / PARAMS_FILE, sharding_of(model) is not None)


def load_params(path, model: Optional[torch.nn.Module] = None):
    """The state dict saved by :func:`save_params`; with ``model``, loaded into
    it strictly (onto its device; a sharded model takes its shards) and the
    model returned."""
    state = torch.load(Path(path) / PARAMS_FILE, map_location="cpu", weights_only=True)
    if model is None:
        return state
    if sharding_of(model) is not None:
        return load_whole_state(model, state)
    model.load_state_dict(state, strict=True)
    return model


def _moments(opt) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer state's tensor dicts by field: AdamW's ``mu``/``nu``,
    adafactor's ``v_row``/``v_col``/``v``."""
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
            if isinstance(getattr(opt, f.name), dict)}


def save_train_state(path, state) -> None:
    """Persist a whole ``training.TrainState`` (parameters, or a LoRA's
    adapters; the optimizer's moments or adafactor's statistics, and its
    count; the step) mid-run to ``<path>/train_state.pt``. Restored with
    :func:`load_train_state`, and with the step seeding the batch order and
    the corruption, a resumed run repeats the uninterrupted one bit for bit."""
    opt = state.opt_state
    _save(
        {
            "params": _whole(state.model),
            "opt_state": {"count": opt.count,
                          **{k: _whole(state.model, v) for k, v in _moments(opt).items()}},
            "step": state.step,
        },
        Path(path) / STATE_FILE,
        sharding_of(state.model) is not None,
    )


def load_train_state(path, template):
    """Restore a state saved by :func:`save_train_state` into ``template`` (a
    fresh ``training.init_state`` of the same model and optimizer), in place:
    the tensors keep the template's devices and dtypes (a sharded template
    takes its shards, whatever mesh the state was saved from). Returns it."""
    blob = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    sharded = sharding_of(template.model) is not None
    if sharded:
        load_whole_state(template.model, blob["params"])
    else:
        template.model.load_state_dict(blob["params"], strict=True)
    opt = template.opt_state
    for key, dst in _moments(opt).items():
        src = blob["opt_state"].get(key, {})
        if dst.keys() != src.keys():
            raise ValueError(f"saved {key} covers other parameters than the template's")
        if sharded:
            src = cut_like(template.model, src)
        for name, t in src.items():
            dst[name].copy_(t)
    opt.count = int(blob["opt_state"]["count"])
    template.step = int(blob["step"])
    return template
