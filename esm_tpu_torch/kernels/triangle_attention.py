"""Fused triangle attention: kernel K6 and its plain version.

Replaces esm_tpu/kernels/triangle_attention.py's ``triangle_attention_fused``
(:96; Pallas body ``_kernel`` :42 through ``_strips`` :65). The kernel is
``esm_tpu_torch/csrc/triangle_attention.cu``; its header says what bounds it
on an H100 and how it is built.

For every batch b, pair row i and head h it computes
softmax(q·kᵀ + tri_bias[b, h] + mask_bias[b, i])·v over the J axis, with
fp32 scores and statistics and the probabilities rounded to v's dtype
before the product. The TPU entry took (B, I, H, d, J) (J on the lane
axis) and split J > 1024 into query strips over a zero-padded J; here q, k,
v and the output are (B, I, J, H, d), the layout the projections give, and
the kernel's online softmax covers every J in one loop. On real rows (a
row with at least one unmasked key) the results are the same; a row whose
keys are all masked averages v over the J real keys here, and over the
padded keys too in the TPU strip path (ROADMAP Queue 3).

CUDA tensors launch the kernel and count the launch
(``triangle_attention_fused.launches``); CPU tensors run
:func:`triangle_attention_reference`. Nothing falls back from the card to
the plain version: a build or launch error raises. The kernel has no
backward: on the card the entry raises when grad mode is on and an input
requires grad (:func:`._grad.refuse_grad`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._grad import refuse_grad

NEG_INF = -1e30  # the key-mask bias of the fused path (the TPU kernel's NEG_INF)
_DTYPES = (torch.float32, torch.bfloat16)
_LIB = "esm_triangle_attention"
# Rows of the plain version handled at once: bounds its (rows, H, J, J) fp32
# scores to about 1 GB at any I.
_PLAIN_SCORES = 1 << 28


def _check(q, k, v, tri_bias, mask_bias) -> Tuple[int, int, int, int, int]:
    if q.dim() != 5:
        raise ValueError(f"q must be (B, I, J, H, d); got {tuple(q.shape)}")
    b, i, j, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k/v must match q {tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d % 8 != 0 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d} unsupported: must be a multiple of 8 in [8, 128]")
    if tri_bias.shape != (b, h, j, j) or tri_bias.dtype != torch.float32:
        raise ValueError(f"tri_bias must be float32 (B, H, J, J) = {(b, h, j, j)}; got "
                         f"{tri_bias.dtype} {tuple(tri_bias.shape)}")
    if mask_bias.shape != (b, i, j) or mask_bias.dtype != torch.float32:
        raise ValueError(f"mask_bias must be float32 (B, I, J) = {(b, i, j)}; got "
                         f"{mask_bias.dtype} {tuple(mask_bias.shape)}")
    if not (q.device == k.device == v.device == tri_bias.device == mask_bias.device):
        raise ValueError("q, k, v, tri_bias and mask_bias must be on one device")
    return b, i, j, h, d


def triangle_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tri_bias: torch.Tensor,
    mask_bias: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of K6, step for step as the TPU body (:42-61):
    s = q·kᵀ in fp32, then + tri_bias, then + mask_bias; m = max, p =
    exp(s - m), l = sum p; o = (p in v's dtype)·v with fp32 accumulation,
    times 1/l (1 where l = 0), in q's dtype. Rows i in chunks, which changes
    memory, not results. Shapes as :func:`triangle_attention_fused`."""
    b, i, j, h, d = _check(q, k, v, tri_bias, mask_bias)
    out = torch.empty_like(q)
    step = max(1, _PLAIN_SCORES // (b * h * j * j))
    for i0 in range(0, i, step):
        sl = slice(i0, i0 + step)
        qc, kc, vc = (x[:, sl].permute(0, 1, 3, 2, 4).float() for x in (q, k, v))  # (B,c,H,J,d)
        s = torch.matmul(qc, kc.transpose(-1, -2))                          # (B, c, H, J, J)
        s = s + tri_bias[:, None]
        s = s + mask_bias[:, sl, None, None, :]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vc)
        o = pv * (1.0 / torch.where(l == 0.0, torch.ones_like(l), l))
        out[:, sl] = o.permute(0, 1, 3, 2, 4).to(q.dtype)
    return out


def _library():
    from ._build import load_library

    lib = load_library(_LIB)
    if lib.esm_triangle_attention_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.esm_triangle_attention_fwd.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
        lib.esm_triangle_attention_fwd.restype = i32
        lib.esm_cuda_error_string.argtypes = [i32]
        lib.esm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def triangle_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tri_bias: torch.Tensor,
    mask_bias: torch.Tensor,
) -> torch.Tensor:
    """K6. q, k, v: (B, I, J, H, d) float32 or bfloat16, q pre-scaled by
    d^-½; tri_bias: (B, H, J, J) fp32, shared by every row i; mask_bias:
    (B, I, J) fp32 additive (0 / -1e30). Returns (B, I, J, H, d) in q's
    dtype. On CUDA the inputs must be contiguous and 16-byte aligned."""
    b, i, j, h, d = _check(q, k, v, tri_bias, mask_bias)
    if q.device.type == "cpu":
        return triangle_attention_reference(q, k, v, tri_bias, mask_bias)
    if q.device.type != "cuda":
        raise ValueError(f"triangle attention runs on cuda or cpu tensors, not {q.device}")
    refuse_grad("triangle_attention_fused (K6)", q, k, v, tri_bias, mask_bias)
    for name, x in (("q", q), ("k", k), ("v", v), ("tri_bias", tri_bias),
                    ("mask_bias", mask_bias)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _library()
    bf16 = q.dtype == torch.bfloat16
    if bf16 and j % 4:
        # the bf16 kernel reads the bias by TMA, which needs 16-byte row
        # strides: rows padded to a multiple of 4 floats (one pass over the
        # bias, B.H.J.J fp32; the padding is never read as a key)
        tri_bias = torch.nn.functional.pad(tri_bias, (0, 4 - j % 4))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.esm_triangle_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tri_bias.data_ptr(),
            mask_bias.data_ptr(), out.data_ptr(), b, i, j, h, d, tri_bias.shape[-1], int(bf16),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"triangle_attention kernel failed: CUDA error {rc} "
                           f"({lib.esm_cuda_error_string(rc).decode()})")
    triangle_attention_fused.launches += 1
    return out


triangle_attention_fused.launches = 0  # K6 launches
