"""Save and restore parameters and whole training states with ``torch.save``.

Port of esm_tpu/io/checkpoint.py:17-90 for one device: the JAX package
writes orbax directories that restore onto a mesh; here a checkpoint is a
directory holding one ``torch.save`` file (``params.pt``, or
``train_state.pt`` for a full state), written to a temporary name and then
renamed, so an interrupted save leaves the previous file whole. Files are
read with ``weights_only=True``: they hold only tensors and numbers. A
released checkpoint in the reference's ``.pt`` layout is loaded by
``pretrained.load_model_and_alphabet`` (``--init-from``), not here.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

import torch

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"


def _save(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_params(path, model: torch.nn.Module) -> None:
    """Write ``model``'s state dict to ``<path>/params.pt``."""
    _save(_cpu(model.state_dict()), Path(path) / PARAMS_FILE)


def load_params(path, model: Optional[torch.nn.Module] = None):
    """The state dict saved by :func:`save_params`; with ``model``, loaded into
    it strictly (onto its device) and the model returned."""
    state = torch.load(Path(path) / PARAMS_FILE, map_location="cpu", weights_only=True)
    if model is None:
        return state
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
            "params": _cpu(state.model.state_dict()),
            "opt_state": {"count": opt.count,
                          **{k: _cpu(v) for k, v in _moments(opt).items()}},
            "step": state.step,
        },
        Path(path) / STATE_FILE,
    )


def load_train_state(path, template):
    """Restore a state saved by :func:`save_train_state` into ``template`` (a
    fresh ``training.init_state`` of the same model and optimizer), in place:
    the tensors keep the template's devices and dtypes. Returns it."""
    blob = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    template.model.load_state_dict(blob["params"], strict=True)
    opt = template.opt_state
    for key, dst in _moments(opt).items():
        src = blob["opt_state"].get(key, {})
        if dst.keys() != src.keys():
            raise ValueError(f"saved {key} covers other parameters than the template's")
        for name, t in src.items():
            dst[name].copy_(t)
    opt.count = int(blob["opt_state"]["count"])
    template.step = int(blob["step"])
    return template
