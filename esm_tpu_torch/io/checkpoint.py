"""Save and restore parameters and whole training states with ``torch.save``.

Port of esm_tpu/io/checkpoint.py:17-90: the JAX package writes orbax
directories that restore onto a mesh; here a checkpoint is a directory
holding an index (``params.pt``, or ``train_state.pt`` for a full state)
and, beside it, a directory of entries, one ``torch.save`` file a tensor.
The entries are written first, the index last, to a temporary name then
renamed, and the previous save's entries are removed only after that: an
interrupted save leaves the previous checkpoint whole. Files are read with
``weights_only=True``: they hold only tensors, numbers and names. The
single-file layout of earlier versions (the whole tree in ``params.pt`` or
``train_state.pt``) still loads. A released checkpoint in the reference's
``.pt`` layout is loaded by ``pretrained.load_model_and_alphabet``
(``--init-from``), not here.

A model sharded by ``parallel.sharding.shard_params`` (pipeline stages
included) saves the whole tree: every rank calls the save, the entries are
gathered over the mesh one at a time, and rank 0 copies each to the host,
writes it and lets it go before the next, so a card holds its shards and
one whole entry, and rank 0's host one whole entry, never the whole tree.
A tree that every rank holds whole (a LoRA module's adapters and their
optimizer state over a sharded base) is written by rank 0 alone when a
process group of several ranks is joined; the other ranks wait for it.
Loading into a sharded model, or ``--resume``, cuts each rank's shard from
the whole entries, read one at a time, so a checkpoint moves between any
meshes, and to one device.
"""

from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import cut_like, iter_whole_state, load_whole_state, sharding_of
from ..training import tensor_fields

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
FORMAT = "esm_tpu_torch.entries/1"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of one whole entry, written and let go by the caller."""
    return t.detach().to("cpu", copy=True)


def _group_of_ranks() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


class _Writer:
    """Writes one tensor a file into a fresh entries directory beside the
    index ``path`` (on the rank that writes; the others pass ``write`` False
    and only iterate), then the index: :meth:`commit`."""

    def __init__(self, path: Path, write: bool):
        self.path, self.write, self.n = path, write, 0
        self.dir = path.with_name(f"{path.stem}.entries-{uuid.uuid4().hex[:12]}")
        if write:
            self.dir.mkdir(parents=True)

    def put(self, t: torch.Tensor) -> str:
        name = f"{self.n}.pt"
        self.n += 1
        if self.write:
            host = _to_host(t)
            torch.save(host, self.dir / name)
            del host
        return name

    def commit(self, tree) -> None:
        if not self.write:
            return
        old = _entries_dir(self.path)
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        torch.save({"format": FORMAT, "dir": self.dir.name, "tree": tree}, tmp)
        os.replace(tmp, self.path)
        if old is not None and old != self.dir and old.is_dir():
            shutil.rmtree(old)


def _entries_dir(index: Path) -> Optional[Path]:
    """The entries directory an existing index names (None for none, or for
    the single-file layout)."""
    if not index.is_file():
        return None
    blob = torch.load(index, map_location="cpu", weights_only=True)
    return index.with_name(blob["dir"]) if _is_index(blob) else None


def _is_index(blob) -> bool:
    return isinstance(blob, dict) and blob.get("format") == FORMAT


def _entries(model: torch.nn.Module, tensors=None, specs=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, whole tensor) of ``model``'s state dict (or of ``tensors``,
    keyed like its parameters), one at a time: gathered over the mesh for a
    sharded model (every rank iterates alike)."""
    if sharding_of(model) is not None:
        yield from iter_whole_state(model, tensors, specs)
    else:
        yield from (model.state_dict() if tensors is None else tensors).items()


def _save(path: Path, model: torch.nn.Module, build) -> None:
    """Write the index ``path`` of the tree ``build(writer)`` returns (its
    tensors written through ``writer.put`` as they come): on a sharded
    model's mesh every rank iterates and rank 0 writes; a whole tree on a
    group of several ranks is written by rank 0 alone; every rank of such a
    group waits for the write."""
    grouped = _group_of_ranks()
    sharded = sharding_of(model) is not None
    rank0 = not grouped or dist.get_rank() == 0
    if rank0 or sharded:
        if rank0:
            path.parent.mkdir(parents=True, exist_ok=True)
        writer = _Writer(path, rank0)
        writer.commit(build(writer))
    if grouped:
        dist.barrier()


def _put_all(writer: _Writer, entries) -> Dict[str, str]:
    out = {}
    for name, whole in entries:
        out[name] = writer.put(whole)
        del whole  # before the next entry is gathered
    return out


class _Lazy(Mapping):
    """The entries of one tree of an index, read from their files as they
    are asked for."""

    def __init__(self, root: Path, files: Dict[str, str]):
        self.root, self.files = root, files

    def __getitem__(self, name: str) -> torch.Tensor:
        return torch.load(self.root / self.files[name], map_location="cpu", weights_only=True)

    def __iter__(self):
        return iter(self.files)

    def __len__(self) -> int:
        return len(self.files)


def _read(index: Path):
    """An index's tree with lazy entries, or a single-file tree as saved by
    earlier versions (its tensors already read)."""
    blob = torch.load(index, map_location="cpu", weights_only=True)
    if not _is_index(blob):
        return blob
    root = index.with_name(blob["dir"])

    def walk(node):
        if isinstance(node, dict) and node and all(isinstance(v, str) for v in node.values()):
            return _Lazy(root, node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(blob["tree"])


def _materialize(node):
    if isinstance(node, Mapping):
        return {k: _materialize(v) for k, v in node.items()}
    return node


def save_params(path, model: torch.nn.Module) -> None:
    """Write ``model``'s state dict to ``<path>/params.pt`` and its entries
    (a sharded model's whole tree, by rank 0)."""
    _save(Path(path) / PARAMS_FILE, model, lambda w: _put_all(w, _entries(model)))


def load_params(path, model: Optional[torch.nn.Module] = None):
    """The state dict saved by :func:`save_params` (either layout); with
    ``model``, loaded into it strictly (onto its device; a sharded model
    takes its shards, reading one entry at a time) and the model
    returned."""
    state = _read(Path(path) / PARAMS_FILE)
    if model is None:
        return _materialize(state)
    if sharding_of(model) is not None:
        return load_whole_state(model, state)
    model.load_state_dict(_materialize(state), strict=True)
    return model


def read_train_state(path) -> dict:
    """The whole tree of a train state saved by :func:`save_train_state`
    (either layout): {"params", "opt_state": {"count", field: {name: tensor}},
    "step"}, every tensor read."""
    return _materialize(_read(Path(path) / STATE_FILE))


def save_train_state(path, state) -> None:
    """Persist a whole ``training.TrainState`` (parameters, or a LoRA's
    adapters; the optimizer's moments or adafactor's statistics, and its
    count; the step) mid-run to ``<path>/train_state.pt`` and its entries.
    Restored with :func:`load_train_state`, and with the step seeding the
    batch order and the corruption, a resumed run repeats the uninterrupted
    one bit for bit."""
    opt, model = state.opt_state, state.model
    specs = getattr(opt, "specs", {})

    def build(writer):
        tree = {"params": _put_all(writer, _entries(model)), "opt_state": {"count": opt.count}}
        for key, tensors in tensor_fields(opt).items():
            tree["opt_state"][key] = _put_all(writer, _entries(model, tensors, specs.get(key)))
        tree["step"] = state.step
        return tree

    _save(Path(path) / STATE_FILE, model, build)


@torch.no_grad()
def load_train_state(path, template):
    """Restore a state saved by :func:`save_train_state` into ``template`` (a
    fresh ``training.init_state`` of the same model and optimizer), in place:
    the tensors keep the template's devices and dtypes (a sharded template
    takes its shards, whatever mesh, pipeline stages included, the state was
    saved from). Returns it."""
    blob = _read(Path(path) / STATE_FILE)
    sharded = sharding_of(template.model) is not None
    if sharded:
        load_whole_state(template.model, blob["params"])
    else:
        template.model.load_state_dict(_materialize(blob["params"]), strict=True)
    opt = template.opt_state
    specs = getattr(opt, "specs", {})
    for key, dst in tensor_fields(opt).items():
        src = blob["opt_state"].get(key, {})
        if sharded:
            pieces = cut_like(template.model, src, dst, specs.get(key))
        else:
            if dst.keys() != src.keys():
                raise ValueError(f"saved {key} covers other parameters than the template's")
            pieces = ((name, src[name]) for name in dst)
        for name, t in pieces:
            dst[name].copy_(t)
    opt.count = int(blob["opt_state"]["count"])
    template.step = int(blob["step"])
    return template
