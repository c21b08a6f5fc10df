"""Device meshes over ``torch.distributed`` for multi-GPU runs.

Port of esm_tpu/parallel/mesh.py. One global mesh with named dimensions

    ("data", "fsdp", "tp")

  * data: batch parallelism;
  * fsdp: ZeRO-3 parameter sharding (``sharding.shard_params``): each rank
    holds a shard of every weight, gathered per layer; the batch is split
    over (data, fsdp);
  * tp: Megatron tensor parallelism for a sharded model (heads and MLP
    columns split over it), or the ring of sequence parallelism
    (``ring_attention``, whose parameters stay replicated, so fsdp splits
    only its batch): the T axis is split over it.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank per GPU (NCCL), or per CPU process
(gloo) when the caller asks for the CPU. esm_tpu's ``named`` (a
NamedSharding for a PartitionSpec) has no counterpart: a sharded model
carries its placement (``sharding.Sharding``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TP)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.data, self.fsdp, self.tp)

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.tp

    @classmethod
    def for_devices(cls, n: int, *, prefer_tp: int = 4) -> "MeshConfig":
        """esm_tpu's factorization: tp gets the largest divisor of ``n`` up to
        ``prefer_tp``, fsdp the rest (pass an explicit MeshConfig for a
        data > 1 layout)."""
        tp = 1
        for cand in range(min(prefer_tp, n), 0, -1):
            if n % cand == 0:
                tp = cand
                break
        return cls(data=1, fsdp=n // tp, tp=tp)


def _device_type(device_type: Optional[str]) -> str:
    """"cuda" unless the caller asks for "cpu"; CUDA must then exist."""
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device_type='cpu' to run on the CPU")
    return device_type


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, fsdp, tp) mesh over every rank of the default process group,
    rank-major as esm_tpu lays its devices out. ``cfg`` defaults to
    :meth:`MeshConfig.for_devices` of the world size."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig.for_devices(world)
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} ranks, the process group "
                         f"has {world}")
    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=AXES)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: Optional[str] = None,
) -> int:
    """Join the job's process group: NCCL on CUDA, with this process on the
    GPU of its ``LOCAL_RANK``; gloo on the CPU. ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` default to the
    launcher's environment (torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE,
    RANK). Returns this process's rank; a second call returns it again."""
    device_type = _device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    return dist.get_rank()


def make_hybrid_mesh(cfg: Optional[MeshConfig] = None,
                     device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh whose ``data`` dimension is outermost across hosts, so that only
    batch and gradient traffic crosses between them while fsdp/tp groups
    stay inside one host (NVLink). Launchers number ranks host by host, so
    the rank-major mesh of :func:`make_mesh` is that layout when fsdp·tp
    divides the ranks of one host (``LOCAL_WORLD_SIZE``). ``cfg`` defaults
    to one data slice per host; ``cfg.data`` must be a multiple of the host
    count."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_hosts = world // per_host
    if cfg is None:
        local = MeshConfig.for_devices(per_host)
        cfg = MeshConfig(data=n_hosts, fsdp=local.fsdp, tp=local.tp)
    if n_hosts > 1 and (cfg.data % n_hosts or per_host % (cfg.fsdp * cfg.tp)):
        raise ValueError(
            f"hybrid mesh: data axis ({cfg.data}) must be a multiple of the host count "
            f"({n_hosts}) and fsdp x tp ({cfg.fsdp * cfg.tp}) must divide the {per_host} ranks "
            "of a host, so that only the data axis crosses hosts")
    return make_mesh(cfg, device_type)


def local_shard(x, mesh: DeviceMesh, *, batch_dim: int = 0, seq_dim: int = 1,
                seq_axis: str = AXIS_TP):
    """This rank's shard of a full tensor (or numpy array) that every rank
    holds: its rows of ``batch_dim`` over the mesh dimensions other than
    ``seq_axis`` (in mesh order, the first outermost) and its block of
    ``seq_dim`` over ``seq_axis``. Both dims must divide evenly."""
    names = mesh.mesh_dim_names
    if seq_axis not in names:
        raise ValueError(f"mesh has no axis {seq_axis!r}: {names}")
    ring = mesh.size(names.index(seq_axis))
    t = x.shape[seq_dim]
    if t % ring:
        raise ValueError(
            f"ring attention: T={t} must be divisible by the {seq_axis!r} axis size {ring} "
            "(pad the sequence, e.g. pad_to_multiple)")
    row_shards, row = 1, 0
    for i, name in enumerate(names):
        if name != seq_axis:
            row_shards *= mesh.size(i)
            row = row * mesh.size(i) + mesh.get_local_rank(i)
    b = x.shape[batch_dim]
    if b % row_shards:
        raise ValueError(f"batch {b} is not divisible by the {row_shards} row shards of "
                         f"mesh {tuple(mesh.shape)}")
    rows, cols = b // row_shards, t // ring
    col = mesh.get_local_rank(names.index(seq_axis))
    index = [slice(None)] * x.ndim
    index[batch_dim] = slice(row * rows, (row + 1) * rows)
    index[seq_dim] = slice(col * cols, (col + 1) * cols)
    return x[tuple(index)]
