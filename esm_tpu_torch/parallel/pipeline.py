"""GPipe pipeline parallelism over a ``pp`` mesh axis.

Port of esm_tpu/parallel/pipeline.py on ``torch.distributed``. The layers
are split into S stages of L/S consecutive layers, one stage per ``pp``
coordinate (``sharding.shard_params`` keeps a rank's own stage only); a
batch is split into M microbatches that flow from stage to stage in
esm_tpu's GPipe order: M + S - 1 ticks, microbatch m entering stage 0 at
tick m and leaving stage S - 1 at tick m + S - 1. tp and fsdp compose inside
a stage: the mesh is ("pp", "data", "fsdp", "tp"), ``pp`` outermost, so a
stage's ranks are a contiguous block.

JAX differentiates through ``ppermute`` and a scan; ``torch.distributed``'s
point-to-point operations are not differentiable, so the schedule is
written out on ``dist.batch_isend_irecv`` (as ``ring_attention`` does) and
the backward is a second schedule in reverse: each stage runs its
microbatches' backward as their output gradients arrive from the next
stage and sends its input gradients to the previous one. A rank computes
only the microbatches in front of it: bubble ticks run nothing (esm_tpu's
SPMD body computes on zeros with a clamped mask there, :162-168).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .mesh import AXES, _device_type
from .sharding import AXIS_PP

PP_AXES = (AXIS_PP,) + AXES


def make_pp_mesh(pp: int, data: int = 1, fsdp: int = 1, tp: int = 1,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """The four-axis mesh ("pp", "data", "fsdp", "tp") over every rank of the
    default process group, ``pp`` outermost so that a stage's ranks are
    neighbours (esm_tpu :40)."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs a process group: call init_multihost first")
    n = pp * data * fsdp * tp
    if n != dist.get_world_size():
        raise ValueError(f"mesh ({pp}, {data}, {fsdp}, {tp}) needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (pp, data, fsdp, tp), mesh_dim_names=PP_AXES)


class Stage:
    """This rank's stage: its index, the stage count, the pp group and the
    global ranks of its neighbours."""

    def __init__(self, mesh: DeviceMesh):
        if AXIS_PP not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no {AXIS_PP!r} axis: {mesh.mesh_dim_names}")
        self.count = mesh.size(mesh.mesh_dim_names.index(AXIS_PP))
        self.index = mesh.get_local_rank(AXIS_PP)
        self.group = mesh.get_group(AXIS_PP) if self.count > 1 else None
        peer = lambda i: dist.get_global_rank(self.group, i)  # noqa: E731
        self.prev = peer(self.index - 1) if self.index > 0 else None
        self.next = peer(self.index + 1) if self.index < self.count - 1 else None
        self.last = peer(self.count - 1) if self.group is not None else None

    @property
    def is_last(self) -> bool:
        return self.index == self.count - 1


def _exchange(ops) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _microbatches(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {m}")
    return list(x.chunk(m))


def pipeline_forward(stage_fn: Callable, x: torch.Tensor, aux=None, *, mesh: DeviceMesh,
                     num_microbatches: int, keep_graph: bool = False):
    """The forward schedule. ``stage_fn(h, aux_mb) -> h`` runs this rank's
    stage on one microbatch. Every stage passes ``x`` (B, ...) (stage 0
    reads its values, the others its shape and dtype) and ``aux`` (leading
    axis B, split with it; e.g. the padding mask). Returns (inputs,
    outputs), this stage's per microbatch; the last stage's outputs are the
    pipeline's. With ``keep_graph`` each input is a leaf that requires grad
    and the outputs keep their graphs, for :func:`pipeline_backward`;
    without it the outputs of other stages than the last are dropped once
    sent."""
    st = Stage(mesh)
    m_count, s, n = num_microbatches, st.index, st.count
    xs = _microbatches(x, m_count)
    if st.group is not None:
        # every stage joins one collective first: NCCL sets up a group's
        # communicator at its first call, which the first tick's send and
        # receive (stages 0 and 1 only) would leave to the other ranks
        dist.all_reduce(torch.zeros(1, device=x.device), group=st.group)
    auxs = _microbatches(aux, m_count) if aux is not None else [None] * m_count
    inputs: List[Optional[torch.Tensor]] = [None] * m_count
    outputs: List[Optional[torch.Tensor]] = [None] * m_count
    for t in range(m_count + n - 1):
        m = t - s          # the microbatch in front of this stage at tick t
        sent = t - 1 - s   # the one it finished at tick t - 1
        ops = []
        if s > 0 and 0 <= m < m_count:  # a receive needs a dense buffer, whatever x's strides
            inputs[m] = torch.empty_like(xs[m], memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, inputs[m], st.prev, st.group))
        if not st.is_last and 0 <= sent < m_count:
            ops.append(dist.P2POp(dist.isend, outputs[sent].detach().contiguous(), st.next,
                                  st.group))
        _exchange(ops)
        if not st.is_last and not keep_graph and 0 <= sent < m_count:
            outputs[sent] = None
        if 0 <= m < m_count:
            h = xs[m] if s == 0 else inputs[m]
            if keep_graph:
                h = h.detach().requires_grad_()
            inputs[m] = h
            outputs[m] = stage_fn(h, auxs[m])
    return inputs, outputs


def pipeline_backward(inputs, outputs, output_grads, *, mesh: DeviceMesh,
                      num_microbatches: int) -> List[torch.Tensor]:
    """The backward schedule, GPipe's forward in reverse: the last stage
    starts from ``output_grads`` (the gradients of its outputs, per
    microbatch; ignored elsewhere), runs the microbatches from the last to
    the first, and each stage sends its inputs' gradients to the previous
    one. The parameters' gradients accumulate in ``.grad``. Returns this
    stage's input gradients per microbatch (stage 0's lead into whatever
    made ``x``)."""
    st = Stage(mesh)
    m_count, s, n = num_microbatches, st.index, st.count
    grads = list(output_grads) if st.is_last else [None] * m_count
    in_grads: List[Optional[torch.Tensor]] = [None] * m_count
    for t in range(m_count + n - 1):
        m = m_count - 1 - (t - (n - 1 - s))          # in front of this stage
        sent = m_count - 1 - (t - 1 - (n - 1 - s))   # finished at tick t - 1
        ops = []
        if not st.is_last and 0 <= m < m_count:
            grads[m] = torch.empty_like(outputs[m], memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, grads[m], st.next, st.group))
        if s > 0 and 0 <= sent < m_count:
            ops.append(dist.P2POp(dist.isend, in_grads[sent].contiguous(), st.prev, st.group))
        _exchange(ops)
        if 0 <= m < m_count:
            torch.autograd.backward(outputs[m], grads[m])
            in_grads[m] = inputs[m].grad
            outputs[m] = grads[m] = None
    return in_grads


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, aux=None, *, mesh: DeviceMesh,
                   num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through the pipeline (no gradients) and return its output
    on every stage: the last stage's, broadcast over ``pp`` (esm_tpu psums
    it). The stages keep ``x``'s shape."""
    st = Stage(mesh)
    with torch.no_grad():
        _, outputs = pipeline_forward(stage_fn, x, aux, mesh=mesh,
                                      num_microbatches=num_microbatches)
        out = (torch.cat(outputs) if st.is_last
               else torch.empty_like(x, memory_format=torch.contiguous_format))
        if st.group is not None:
            dist.broadcast(out, src=st.last, group=st.group)
    return out


def stage_function(layers, static) -> Callable:
    """``stage_fn`` of a transformer stack: this stage's ``layers`` in order
    (remat per layer with ``static.remat``), the padding mask as ``aux``."""
    from ..models.lm_common import transformer_stack_apply

    def run(h, mask):
        return transformer_stack_apply(layers, h, static=static, key_padding_mask=mask)[0]

    return run


def pipeline_transformer_stack(layers, x: torch.Tensor, *, static, shard, num_microbatches: int,
                               key_padding_mask: torch.Tensor) -> torch.Tensor:
    """Pipelined counterpart of lm_common.transformer_stack_apply's plain
    path (esm_tpu :212; no hidden states or attention maps): ``layers`` are
    this rank's stage's, ``shard`` the model's Sharding over a pp mesh.
    Returns the stack's output on every stage."""
    return pipeline_apply(stage_function(layers, static), x, key_padding_mask, mesh=shard.mesh,
                          num_microbatches=num_microbatches)
