"""The triangular multiplicative update's two row-wise stages: kernels K7
(stage 1) and K8 (the epilogue), and their plain versions.

Replaces esm_tpu/kernels/triangle_mul.py: ``tri_mul_stage1`` (:147; Pallas
body ``_stage1_impl`` :45) and ``tri_mul_epilogue`` (:186; ``_epilogue_kernel``
:81), both launched through ``_rows_call`` (:109). The kernels are in
``esm_tpu_torch/csrc/triangle_mul.cu``; its header says what bounds them on
an H100 and how they are built. Both view the pair tensor (B, I, J, C) as
rows (B·I·J, C):

  stage 1:   zn = LN_in(z) (fp32, rounded to z's dtype); p = zn·W4 + b4 with
             W4 = [a_g | a_p | b_g | b_p] and b4 rounded to z's dtype;
             a = m·σ(p_ag)·p_ap, b = m·σ(p_bg)·p_bp in fp32, returned in z's
             dtype; m the optional row mask (cast to int8, as the TPU entry
             does), not read at all when None;
  epilogue:  z + (σ(LN_in(z)·Wg + bg)·(LN_out(x)·Wz + bz)).astype(z.dtype),
             x cast to z's dtype first; fp32 LNs, eps 1e-5.

CUDA tensors launch the kernels and count the launches
(``tri_mul_stage1.launches``, ``tri_mul_epilogue.launches``); CPU tensors run
the plain versions. Nothing falls back from the card to the plain versions.
The kernels have no backward: on the card both entries raise when grad mode
is on and an input or one of the module's weights requires grad
(:func:`._grad.refuse_grad`); the plain versions on the CPU differentiate.
The weights come from the port's ``TriangleMultiplication`` module (torch
``Linear`` layout, (out, in)).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.common import materialize_weight
from ._grad import refuse_grad

_DTYPES = (torch.float32, torch.bfloat16)
_CHANNELS = (32, 64, 128)
_LIB = "esm_triangle_mul"
_GATES = ("linear_a_g", "linear_a_p", "linear_b_g", "linear_b_p")


def _ln_rows(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """fp32 LayerNorm over the last axis, as the TPU kernels write it."""
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def stage1_weights(mod, dtype) -> Tuple[torch.Tensor, ...]:
    """(W4 (4C, C), b4 (4C,)) in ``dtype``, LN scale and bias (C,) fp32."""
    w4 = torch.cat([materialize_weight(getattr(mod, n), dtype) for n in _GATES], dim=0).contiguous()
    b4 = torch.cat([getattr(mod, n).bias for n in _GATES]).to(dtype).contiguous()
    ln = mod.layer_norm_in
    return w4, b4, ln.weight.float().contiguous(), ln.bias.float().contiguous()


def epilogue_weights(mod, dtype) -> Tuple[torch.Tensor, ...]:
    """Wg, bg, Wz, bz in ``dtype``; LN_in and LN_out scale and bias fp32."""
    out = []
    for name in ("linear_g", "linear_z"):
        lin = getattr(mod, name)
        out += [materialize_weight(lin, dtype).contiguous(), lin.bias.to(dtype).contiguous()]
    for ln in (mod.layer_norm_in, mod.layer_norm_out):
        out += [ln.weight.float().contiguous(), ln.bias.float().contiguous()]
    return tuple(out)


def tri_mul_stage1_reference(z, mask, w4, b4, ln_s, ln_b):
    """Plain version of K7 on rows: z (rows, C); mask (rows,) int8 or None."""
    c = z.shape[-1]
    zn = _ln_rows(z.float(), ln_s, ln_b).to(z.dtype)
    p = torch.matmul(zn.float(), w4.float().t()) + b4.float()
    a = torch.sigmoid(p[:, :c]) * p[:, c:2 * c]
    b = torch.sigmoid(p[:, 2 * c:3 * c]) * p[:, 3 * c:]
    if mask is not None:
        m = mask.float()[:, None]
        a, b = m * a, m * b
    return a.to(z.dtype), b.to(z.dtype)


def tri_mul_epilogue_reference(x, z, wg, bg, wz, bz, lni_s, lni_b, lno_s, lno_b):
    """Plain version of K8 on rows: x, z (rows, C) in z's dtype."""
    zn = _ln_rows(z.float(), lni_s, lni_b).to(z.dtype)
    g = torch.sigmoid(torch.matmul(zn.float(), wg.float().t()) + bg.float())
    xn = _ln_rows(x.float(), lno_s, lno_b).to(z.dtype)
    u = torch.matmul(xn.float(), wz.float().t()) + bz.float()
    return z + (g * u).to(z.dtype)


def _library():
    from ._build import load_library

    lib = load_library(_LIB)
    if lib.esm_tri_mul_stage1.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.esm_tri_mul_stage1.argtypes = [ptr] * 8 + [i64, i32, i32, ptr]
        lib.esm_tri_mul_epilogue.argtypes = [ptr] * 11 + [i64, i32, i32, ptr]
        for fn in (lib.esm_tri_mul_stage1, lib.esm_tri_mul_epilogue):
            fn.restype = i32
        lib.esm_cuda_error_string.argtypes = [i32]
        lib.esm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(z: torch.Tensor) -> Tuple[int, int]:
    if z.dtype not in _DTYPES:
        raise TypeError(f"z must be float32 or bfloat16; got {z.dtype}")
    c = z.shape[-1]
    rows = z.numel() // c
    if z.device.type == "cuda" and c not in _CHANNELS:
        raise ValueError(f"channels {c} unsupported by the kernel: must be one of {_CHANNELS}")
    return rows, c


def _launch(fn, name: str, lib, tensors, *ints) -> None:
    for i, x in enumerate(tensors):
        if x is None:
            continue
        if x.device.type != "cuda" or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: argument {i} must be a contiguous, 16-byte aligned "
                             f"CUDA tensor")
    device = next(x for x in tensors if x is not None).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[None if x is None else x.data_ptr() for x in tensors], *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} "
                           f"({lib.esm_cuda_error_string(rc).decode()})")


def tri_mul_stage1(z: torch.Tensor, mask: Optional[torch.Tensor], mod):
    """K7. z: (B, I, J, C); mask: (B, I, J) or None (all valid: no mask
    stream). ``mod`` holds the layers (``TriangleMultiplication``). Returns
    the gated a, b (B, I, J, C) in z's dtype."""
    rows, c = _check_rows(z)
    w4, b4, ln_s, ln_b = stage1_weights(mod, z.dtype)
    zf = z.reshape(rows, c)
    mf = None if mask is None else mask.reshape(rows).to(torch.int8)
    if z.device.type == "cpu":
        a, b = tri_mul_stage1_reference(zf, mf, w4, b4, ln_s, ln_b)
        return a.reshape(z.shape), b.reshape(z.shape)
    refuse_grad("tri_mul_stage1 (K7)", z, mask, w4, b4, ln_s, ln_b)
    lib = _library()
    zf = zf.contiguous()
    a, b = torch.empty_like(zf), torch.empty_like(zf)
    _launch(lib.esm_tri_mul_stage1, "tri_mul_stage1", lib,
            [zf, None if mf is None else mf.contiguous(), w4, b4, ln_s, ln_b, a, b],
            rows, c, int(z.dtype == torch.bfloat16))
    tri_mul_stage1.launches += 1
    return a.reshape(z.shape), b.reshape(z.shape)


def tri_mul_epilogue(x: torch.Tensor, z: torch.Tensor, mod) -> torch.Tensor:
    """K8. Returns z + σ(LN_in(z)·Wg + bg)·(LN_out(x)·Wz + bz), (B, I, J, C)
    in z's dtype; x is cast to z's dtype first."""
    rows, c = _check_rows(z)
    weights = epilogue_weights(mod, z.dtype)
    xf = x.reshape(rows, c).to(z.dtype)
    zf = z.reshape(rows, c)
    if z.device.type == "cpu":
        return tri_mul_epilogue_reference(xf, zf, *weights).reshape(z.shape)
    refuse_grad("tri_mul_epilogue (K8)", x, z, *weights)
    lib = _library()
    xf, zf = xf.contiguous(), zf.contiguous()
    out = torch.empty_like(zf)
    _launch(lib.esm_tri_mul_epilogue, "tri_mul_epilogue", lib, [xf, zf, *weights, out],
            rows, c, int(z.dtype == torch.bfloat16))
    tri_mul_epilogue.launches += 1
    return out.reshape(z.shape)


tri_mul_stage1.launches = 0    # K7 launches
tri_mul_epilogue.launches = 0  # K8 launches
