"""Rigid-frame (rotation + translation) math.

Port of esm_tpu/ops/rigid.py (from-scratch equivalents of the openfold
Rigid/Rotation utilities the reference's structure module uses,
esm/esmfold/v1/trunk.py:11,144). Rotations are (..., 3, 3) matrices;
quaternions appear only in the backbone update and the 7-vector frame
output. The 3x3 products are written as broadcast multiplies and sums, not
matrix products, so they stay in full fp32 whatever the TF32 setting.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Rigid(NamedTuple):
    rots: torch.Tensor   # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)

    @property
    def shape(self):
        return self.trans.shape[:-1]

    def __getitem__(self, idx) -> "Rigid":
        """Index the batch dims only (the trailing (3, 3) / (3,) are kept)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Rigid(self.rots[idx + (slice(None), slice(None))],
                     self.trans[idx + (slice(None),)])

    def unsqueeze(self, dim: int) -> "Rigid":
        """A new batch axis at ``dim`` (counted among the batch dims)."""
        d = dim if dim >= 0 else len(self.shape) + 1 + dim
        return Rigid(self.rots.unsqueeze(d), self.trans.unsqueeze(d))


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v over (..., 3, 3) and (..., 3), broadcast."""
    return (m * v[..., None, :]).sum(-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over (..., 3, 3) pairs, broadcast."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def identity(shape: Tuple[int, ...], dtype=torch.float32, device=None) -> Rigid:
    rots = torch.eye(3, dtype=dtype, device=device).expand(tuple(shape) + (3, 3))
    return Rigid(rots, torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))


def apply(r: Rigid, pts: torch.Tensor) -> torch.Tensor:
    """R p + t."""
    return _matvec(r.rots, pts) + r.trans


def invert_apply(r: Rigid, pts: torch.Tensor) -> torch.Tensor:
    """R^T (p - t)."""
    return _matvec(r.rots.transpose(-1, -2), pts - r.trans)


def compose(a: Rigid, b: Rigid) -> Rigid:
    """a applied after b: (Ra Rb, Ra tb + ta)."""
    return Rigid(_matmul(a.rots, b.rots), _matvec(a.rots, b.trans) + a.trans)


def scale_translation(r: Rigid, factor: float) -> Rigid:
    return Rigid(r.rots, r.trans * factor)


def stop_rot_gradient(r: Rigid) -> Rigid:
    """The rotations detached, the translations kept (AF2 Alg. 20 line 20:
    the structure module stops the rotation gradient between blocks)."""
    return Rigid(r.rots.detach(), r.trans)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion (..., 4) [w, x, y, z] -> rotation matrix."""
    w, x, y, z = q.unbind(-1)
    rot = torch.stack(
        [
            1 - 2.0 * (y * y + z * z), 2.0 * (x * y - z * w), 2.0 * (x * z + y * w),
            2.0 * (x * y + z * w), 1 - 2.0 * (x * x + z * z), 2.0 * (y * z - x * w),
            2.0 * (x * z - y * w), 2.0 * (y * z + x * w), 1 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return rot.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) [w, x, y, z], by the
    branch method of esm_tpu (the candidate stable for the largest of trace,
    m00 - m11 - m22, ...), normalized, with w >= 0."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    cands = torch.stack(
        [
            torch.stack([1.0 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
            torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
        ],
        dim=-2,
    )  # (..., 4 cases, 4)
    case = torch.stack(
        [m00 + m11 + m22, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1
    ).argmax(-1)
    q = torch.gather(cands, -2, case[..., None, None].expand(case.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def compose_q_update_vec(r: Rigid, update: torch.Tensor) -> Rigid:
    """Backbone update (AF2 Alg. 23): update (..., 6) = (b, c, d, tx, ty, tz).
    Quaternion (1, b, c, d) normalized -> rotation composed on the right;
    the translation applied in the current frame."""
    q_vec, t_vec = update[..., :3], update[..., 3:]
    quat = torch.cat([torch.ones_like(q_vec[..., :1]), q_vec], dim=-1)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return Rigid(_matmul(r.rots, quat_to_rot(quat)), _matvec(r.rots, t_vec) + r.trans)


def to_tensor_7(r: Rigid) -> torch.Tensor:
    """(..., 7): quaternion (w, x, y, z) then translation."""
    return torch.cat([rot_to_quat(r.rots), r.trans], dim=-1)


def to_tensor_4x4(r: Rigid) -> torch.Tensor:
    """Homogeneous (..., 4, 4) transform."""
    top = torch.cat([r.rots, r.trans[..., None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros(r.trans.shape[:-1] + (1, 4), dtype=r.trans.dtype,
                         device=r.trans.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_tensor_4x4(t: torch.Tensor) -> Rigid:
    return Rigid(t[..., :3, :3], t[..., :3, 3])
