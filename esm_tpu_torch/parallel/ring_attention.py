"""Ring attention: self-attention with the sequence split over a mesh axis.

Port of esm_tpu/parallel/ring_attention.py on ``torch.distributed``. Each
rank of the ring (the mesh's ``tp`` dimension) holds a block of T/N query,
key and value rows. The key/value blocks rotate around the ring by
point-to-point sends while each rank attends to the block in front of it,
so a rank never holds more than two blocks of keys. The cross-block
softmax combine is exact.

JAX differentiates through ``ppermute``; ``torch.distributed``'s
point-to-point operations are not differentiable, so both bodies are one
``torch.autograd.Function`` with an explicit backward ring:
  * forward: each block gives its output and log-sum-exp, combined by
    log-sum-exp (esm_tpu's ``_ring_flash_scan``, :49-88); with ``use_flash``
    a block is kernel K4 (``flash_attention_with_lse``) on CUDA tensors,
    otherwise the plain block math of esm_tpu's ``_local_attend`` (:29)
    with an online softmax (``_ring_body``, :135);
  * backward: a second ring (``_ring_flash_bwd_scan``, :91-132): every block
    gives exact dq/dk/dv partials against the saved global output and lse
    (kernel K5, ``flash_attention_block_bwd``, with ``use_flash``); dq sums
    in fp32 on the rank, each block's dk/dv travel with the block and are
    home after N rotations.

Rows whose keys are all padding come out as exact zeros (:85-87), and their
upstream cotangent is zeroed before the backward ring (:102-106). The next
block's sends are posted before the current block's attention runs, so the
transfer overlaps it. A ring of one rank sends nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..kernels.flash_attention import (
    flash_attention_block_bwd,
    flash_attention_with_lse,
)

NEG_INF = -1e30  # key-padding bias, as in esm_tpu and the kernels


class _Ring:
    """The ring of one mesh dimension: this rank's place in it and the global
    ranks of its neighbours (blocks travel from rank i to rank i + 1)."""

    def __init__(self, mesh, axis_name: str):
        if axis_name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {axis_name!r}: {mesh.mesh_dim_names}")
        self.group = mesh.get_group(axis_name)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.send_to = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        self.recv_from = dist.get_global_rank(self.group, (self.rank - 1) % self.size)

    def rotate(self, tensors: Sequence[Optional[torch.Tensor]], tag: int) -> "_Transfer":
        """Post the sends of ``tensors`` to the next rank and the receives of
        their successors from the previous one; None entries travel as None.
        Tags keep the messages of one step apart on backends that match by
        tag (gloo)."""
        ops, received = [], []
        for i, t in enumerate(tensors):
            if t is None:
                received.append(None)
                continue
            wire = t.view(torch.uint8) if t.dtype == torch.bool else t
            r = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.isend, wire, self.send_to, self.group, tag + i))
            ops.append(dist.P2POp(dist.irecv, r, self.recv_from, self.group, tag + i))
            received.append((r, t.dtype))
        return _Transfer(dist.batch_isend_irecv(ops), received)


class _Transfer:
    def __init__(self, works, received):
        self.works, self.received = works, received

    def wait(self) -> List[Optional[torch.Tensor]]:
        for w in self.works:
            w.wait()
        return [None if r is None else (r[0].view(torch.bool) if r[1] == torch.bool else r[0])
                for r in self.received]


def _keep(mask: Optional[torch.Tensor], q: torch.Tensor, s: int) -> torch.Tensor:
    """(B, 1, 1, S) fp32: 1 at real keys, 0 at padding."""
    if mask is None:
        return torch.ones((q.shape[0], 1, 1, s), dtype=torch.float32, device=q.device)
    return (~mask).to(torch.float32)[:, None, None, :]


def _local_attend(q, k, v, mask):
    """One block of plain attention (esm_tpu's ``_local_attend``): q (B, H,
    Tq, d), k/v (B, H, Tk, d). Returns (unnormalised out, row max, row sum),
    fp32. Padded keys get exact zeros, so a row with no real key in the
    block has a zero sum."""
    keep = _keep(mask, q, k.shape[2])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + (1 - keep) * NEG_INF
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype), v).float()
    return acc, m, l


def _local_attend_bwd(q, k, v, mask, out, lse, do):
    """The plain block backward against the global out and lse, fp32:
    P = exp(q.k - lse) at real keys, dS = P (do.v - rowsum(do * out))."""
    keep = _keep(mask, q, k.shape[2])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) + (1 - keep) * NEG_INF
    p = torch.exp(s - lse[..., None]) * keep
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
            torch.matmul(p.transpose(-1, -2), dof))


def _combine(out, lse, blk_out, blk_lse):
    """Fold one key block's normalised output and lse into the running fp32
    (out, lse): out = sum_i out_i exp(lse_i - lse), exactly."""
    new_lse = torch.logaddexp(lse, blk_lse)
    return (out * torch.exp(lse - new_lse)[..., None]
            + blk_out.float() * torch.exp(blk_lse - new_lse)[..., None]), new_lse


def _zero_dead_rows(out, lse):
    """A row with no real key anywhere combined the kernel's average of
    masked values with weight 1 at every step: zero it."""
    return out.masked_fill((lse <= 0.5 * NEG_INF)[..., None], 0.0)


def _ring_forward(q, k, v, mask, ring: _Ring, use_flash: bool):
    """Returns (out in q's dtype, global lse (B, H, Tq) fp32)."""
    b, h, tq, d = q.shape
    block = (k, v, mask)
    if use_flash:
        out = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    for step in range(ring.size):
        pending = ring.rotate(block, tag=0) if step < ring.size - 1 else None
        kb, vb, mb = block
        if use_flash:
            out, lse = _combine(out, lse,
                                *flash_attention_with_lse(q, kb, vb, key_padding_mask=mb))
        else:
            blk_acc, blk_m, blk_l = _local_attend(q, kb, vb, mb)
            m_new = torch.maximum(m, blk_m)
            alpha, beta = torch.exp(m - m_new), torch.exp(blk_m - m_new)
            acc = acc * alpha + blk_acc * beta
            l = l * alpha + blk_l * beta
            m = m_new
        if pending is not None:
            block = tuple(pending.wait())
    if use_flash:
        out = _zero_dead_rows(out, lse)
    else:
        out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
        lse = torch.where(l > 0.0, m + torch.log(l), torch.full_like(l, NEG_INF))[..., 0]
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, mask, out, lse, do, ring: _Ring, use_flash: bool):
    """(dq, dk, dv) of the ring, in q's dtype."""
    # the forward's zeroing of rows with no real key blocks their cotangent
    do = do.masked_fill((lse <= 0.5 * NEG_INF)[..., None], 0.0).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    block, grads = (k, v, mask), None
    for step in range(ring.size):
        pending = ring.rotate(block, tag=0) if step < ring.size - 1 else None
        kb, vb, mb = block
        if use_flash:
            parts = flash_attention_block_bwd(q, kb, vb, out, lse, do, key_padding_mask=mb)
        else:
            parts = _local_attend_bwd(q, kb, vb, mb, out, lse, do)
        dq = dq + parts[0].float()
        if grads is not None:  # this block's dk/dv, from the ranks it visited before
            dk, dv = grads.wait()
        dk = dk + parts[1].float()
        dv = dv + parts[2].float()
        if ring.size > 1:  # they travel on with the block: home after N steps
            grads = ring.rotate((dk, dv), tag=3)
        if pending is not None:
            block = tuple(pending.wait())
    if grads is not None:
        dk, dv = grads.wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, ring, use_flash):
        out, lse = _ring_forward(q, k, v, mask, ring, use_flash)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.ring, ctx.use_flash = ring, use_flash
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, mask, out, lse, do, ctx.ring, ctx.use_flash)
        return dq, dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "tp",
    key_padding_mask: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Attention over a sequence split along ``mesh``'s ``axis_name``: q/k/v
    are this rank's (B, H, T/N, d) blocks (rank i of the ring holds rows
    i·T/N to (i + 1)·T/N - 1), ``key_padding_mask`` its (B, T/N) bool block,
    True at padding. q must be pre-scaled. Every rank of the ring must call
    it together. ``use_flash`` runs each block through kernel K4 forward and
    K5 backward (their plain versions for CPU tensors). Returns this rank's
    (B, H, T/N, d) output in q's dtype; differentiable in q, k and v."""
    ring = _Ring(mesh, axis_name)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if key_padding_mask is not None:
        key_padding_mask = key_padding_mask.contiguous()
    return _RingAttention.apply(q, k, v, key_padding_mask, ring, use_flash)
