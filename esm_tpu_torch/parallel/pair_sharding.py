"""The collectives of the sharded fold: ESMFold's (B, L, L, C) pair tensors
with their rows split over one mesh dimension.

esm_tpu shards the pair tensor with ``FoldingTrunkConfig.pair_spec`` and
lets XLA insert the collectives. The port calls its layers functionally, so
it writes them out here, after FastFold's Dynamic Axial Parallelism
(arXiv 2203.00854): rank r of the ``tp`` group holds rows
``[r·L/N, (r+1)·L/N)`` of every pair tensor, with all L columns.

  * :func:`gather_rows`: the rows of every rank, ``all_gather_into_tensor``
    (the tri-mul's second operand, the triangle bias, the sequence track's
    attention output, IPA's output);
  * :func:`rows_to_cols` and :func:`cols_to_rows`: the transpose between row
    and column sharding, one ``all_to_all_single`` over N contiguous, equal
    pieces (the incoming tri-mul, the ending-node attention, the
    distogram's symmetrization);
  * :func:`all_reduce_max`: the pTM's maximum over the rows.

L must divide by N: the fold pads its residues to ``Lp = ⌈L/N⌉·N`` with
mask 0 (``esmfold.apply_sharded``). A shard of one rank has no group: every
collective is then the identity, so a one-rank group computes the unsharded
fold's numbers exactly. The collectives have no backward: under grad mode
they raise for an input that requires grad, as kernels K6-K8 do
(``kernels/_grad.py``); the sharded fold runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..kernels._grad import refuse_grad


@dataclass(frozen=True)
class PairShard:
    """This rank's place in the pair-row group: ``size`` ranks over a padded
    length ``length`` (a multiple of ``size``); ``group`` is None for one rank."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    length: int

    @property
    def rows(self) -> int:
        return self.length // self.size

    @property
    def row_slice(self) -> slice:
        return slice(self.rank * self.rows, (self.rank + 1) * self.rows)

    def local(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of a tensor every rank holds whole, along ``dim``."""
        return x.narrow(dim, self.rank * self.rows, self.rows)


def pair_shard(mesh, axis_name: str, length: int) -> PairShard:
    """The pair-row shard of ``mesh``'s ``axis_name`` dimension for a padded
    length ``length``."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r}: {mesh.mesh_dim_names}")
    dim = mesh.mesh_dim_names.index(axis_name)
    size = mesh.size(dim)
    if length % size:
        raise ValueError(f"pair rows: L={length} must be a multiple of the {axis_name!r} size "
                         f"{size} (pad the residues with mask 0)")
    return PairShard(None if size == 1 else mesh.get_group(axis_name), size,
                     mesh.get_local_rank(dim), length)


def gather_rows(x: torch.Tensor, shard: PairShard, dim: int = 1) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, in rank order (the whole tensor)."""
    refuse_grad("gather_rows", x)
    if shard.group is None:
        return x
    piece = x.movedim(dim, 0).contiguous()
    out = piece.new_empty((shard.size * piece.shape[0],) + piece.shape[1:])
    dist.all_gather_into_tensor(out, piece, group=shard.group)
    return out.movedim(0, dim)


def _all_to_all(pieces: torch.Tensor, shard: PairShard) -> torch.Tensor:
    """``pieces`` (N, ...): piece s goes to rank s; returns (N, ...), piece r
    from rank r."""
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=shard.group)
    return out


def rows_to_cols(x: torch.Tensor, shard: PairShard) -> torch.Tensor:
    """(B, L/N, L, ...) row-sharded -> (B, L, L/N, ...): this rank's block of
    columns, every row."""
    refuse_grad("rows_to_cols", x)
    if shard.group is None:
        return x
    b, r, length = x.shape[:3]
    rest = x.shape[3:]
    n, c = shard.size, length // shard.size
    # piece s: my rows of rank s's columns
    pieces = x.reshape(b, r, n, c, *rest).movedim(2, 0).contiguous()
    got = _all_to_all(pieces, shard)                     # piece q: rank q's rows, my columns
    return got.movedim(0, 1).reshape(b, n * r, c, *rest)


def cols_to_rows(x: torch.Tensor, shard: PairShard) -> torch.Tensor:
    """(B, L, L/N, ...) column-sharded -> (B, L/N, L, ...): this rank's rows,
    every column. The inverse of :func:`rows_to_cols`."""
    refuse_grad("cols_to_rows", x)
    if shard.group is None:
        return x
    b, length, c = x.shape[:3]
    rest = x.shape[3:]
    n, r = shard.size, length // shard.size
    # piece s: rank s's rows of my columns
    pieces = x.reshape(b, n, r, c, *rest).movedim(1, 0).contiguous()
    got = _all_to_all(pieces, shard)                     # piece q: my rows, rank q's columns
    return got.movedim(0, 2).reshape(b, r, n * c, *rest)


def transpose_rows(x: torch.Tensor, shard: PairShard) -> torch.Tensor:
    """The row shard of xᵀ (dims 1 and 2 swapped) from the row shard of x:
    (B, L/N, L, ...) -> (B, L/N, L, ...) with out[:, i, j] = x[:, j, i]."""
    return rows_to_cols(x, shard).transpose(1, 2)


def all_reduce_max(x: torch.Tensor, shard: PairShard) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group."""
    refuse_grad("all_reduce_max", x)
    if shard.group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=shard.group)
    return x
