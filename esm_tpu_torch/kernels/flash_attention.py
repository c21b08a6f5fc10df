"""Flash attention: the forward (kernel K1, with or without the per-row
log-sum-exp), the backward (kernel K2), their plain versions, and the
autograd Function that joins them.

Replaces esm_tpu/kernels/flash_attention.py:
  * K1: ``flash_attention`` (:1026) and ``flash_attention_dmajor`` (:1077),
    which reach the Pallas bodies ``_single_pass_kernel`` (:300) and
    ``_flash_kernel`` (:211) through ``_flash_core`` (:884) and
    ``_flash_padded`` (:394); ``with_lse=True`` adds the log-sum-exp;
  * K2: ``_flash_bwd_padded`` (:730) with ``_dq_kernel`` (:590) and
    ``_dkv_kernel`` (:652), the backward of ``_flash_core``'s custom_vjp;
  * K4: ``flash_attention_with_lse`` (:938), K1 with the lse, no rotary;
  * K5: ``flash_attention_block_bwd`` (:975), K2 against one key block.
The kernels are ``esm_tpu_torch/csrc/flash_attention.cu`` (K1) and
``flash_attention_bwd.cu`` (K2); their headers say what bounds them on an
H100 and how they are built.

:func:`flash_attention` is differentiable: when grad is enabled and an input
requires grad it runs :class:`FlashAttention` (K1 with the lse forward, K2
backward); otherwise K1 without the lse, as the JAX primal does. CUDA tensors
launch the kernels and count each launch (``flash_attention.launches``,
``flash_attention_with_lse.launches``, ``flash_attention_bwd.launches_dq``
and ``.launches_dkv``). CPU tensors run the plain versions
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`),
the same math in plain PyTorch. Nothing falls back from the card to the
plain versions: a build or launch error raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..ops.rotary import rotary_tables

NEG_INF = -1e30  # key-padding bias (the TPU kernel's NEG_INF)
_DTYPES = (torch.float32, torch.bfloat16)
_FWD, _BWD = "esm_flash_attention", "esm_flash_attention_bwd"


def _check(q, k, v, key_padding_mask) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be (B, H, T, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, H, S, d) matching q {tuple(q.shape)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 != 0 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d} unsupported: must be a multiple of 8 in [8, 128]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if key_padding_mask is not None:
        if key_padding_mask.shape != (b, s) or key_padding_mask.dtype != torch.bool:
            raise ValueError(f"key_padding_mask must be bool (B, S) = {(b, s)}; got "
                             f"{key_padding_mask.dtype} {tuple(key_padding_mask.shape)}")
        if key_padding_mask.device != q.device:
            raise ValueError("key_padding_mask must be on q's device")
    if t == 0 or s == 0:
        raise ValueError("empty query or key axis")
    return b, h, t, s, d


def _check_grad_inputs(q, out, lse, do) -> None:
    b, h, t, d = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do must be {tuple(q.shape)}; got {tuple(out.shape)}, "
                         f"{tuple(do.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"out/do must be {q.dtype}; got {out.dtype}, {do.dtype}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 (B, H, T) = {(b, h, t)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (out.device == lse.device == do.device == q.device):
        raise ValueError("out, lse and do must be on q's device")


def _scores(q, k, key_padding_mask):
    """fp32 q.k^T (B, H, T, S) plus the -1e30 padding bias."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32, device=q.device)
        bias = bias.masked_fill(key_padding_mask, NEG_INF)
        scores = scores + bias[:, None, None, :]
    return scores


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    rotary: bool = False,
    return_lse: bool = False,
):
    """Plain PyTorch version of K1, step for step: rotary in fp32 from fp32
    tables and rounded to q's dtype, fp32 scores plus the -1e30 padding bias,
    fp32 softmax statistics, the probabilities rounded to v's dtype for the
    p.v product with fp32 accumulation, a zero row sum divided by 1. With
    ``return_lse`` also the per-row log-sum-exp m + log(max(l, 1e-37)),
    (B, H, T) fp32."""
    b, h, t, s, d = _check(q, k, v, key_padding_mask)
    if rotary:
        cos, sin = rotary_tables(max(t, s), d, device=q.device)
        q = _rotate_f32(q, cos[:t], sin[:t])
        k = _rotate_f32(k, cos[:s], sin[:s])
    scores = _scores(q, k, key_padding_mask)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (out / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l.clamp_min(1e-37)))[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    rotary: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, step for step. ``k`` is the key matrix the
    forward's main loop read: rot(k) when ``rotary``, whose gradient is
    pulled back through the rotation. delta = rowsum(do * out) in fp32;
    P = exp(q.k + bias - lse) recomputed in fp32; dS = P (do.v - delta);
    dq = dS.k and dk = dS^T.q with dS rounded to the operand's dtype,
    dv = P^T.do with P rounded to do's dtype, fp32 accumulation; dq and dk
    un-rotated in fp32. Returns (dq, dk, dv) in q's dtype."""
    b, h, t, s, d = _check(q, k, v, key_padding_mask)
    _check_grad_inputs(q, out, lse, do)
    if rotary:
        cos, sin = rotary_tables(max(t, s), d, device=q.device)
        q = _rotate_f32(q, cos[:t], sin[:t])
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    p = torch.exp(_scores(q, k, key_padding_mask) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    if rotary:
        dq = _unrotate_f32(dq, cos[:t], sin[:t])
        dk = _unrotate_f32(dk, cos[:s], sin[:s])
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _rotate_f32(x, cos, sin):
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def _unrotate_f32(g, cos, sin):
    """Transpose of the rotary on an fp32 cotangent (esm_tpu's ``_unrotate``):
    both halves of the tables are equal, so it is cos.g - sin.rotate_half(g)."""
    g1, g2 = g.chunk(2, dim=-1)
    return g * cos - torch.cat([-g2, g1], dim=-1) * sin


@functools.lru_cache(maxsize=32)
def _device_tables(length: int, d: int, device: torch.device):
    """fp32 (length, d) cos/sin tables on ``device``, built once per shape."""
    cos, sin = rotary_tables(length, d, device=device)
    return cos.contiguous(), sin.contiguous()


def _libraries():
    from ._build import LIBRARIES, load_libraries

    libs = load_libraries({name: LIBRARIES[name] for name in (_FWD, _BWD)})
    fwd, bwd = libs[_FWD], libs[_BWD]
    if fwd.esm_flash_attention_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptrs in ((fwd.esm_flash_attention_fwd, 10),
                           (bwd.esm_flash_attention_bwd_dq, 12),
                           (bwd.esm_flash_attention_bwd_dkv, 11)):
            fn.argtypes = [ptr] * n_ptrs + [i32] * 6 + [ptr]
            fn.restype = i32
        for lib in (fwd, bwd):
            lib.esm_cuda_error_string.argtypes = [i32]
            lib.esm_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel failed: CUDA error {rc} ({lib.esm_cuda_error_string(rc).decode()})"
        )


def _require_cuda_layout(**tensors) -> None:
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"flash attention runs on cuda or cpu tensors, not {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x, or a contiguous 16-byte-aligned copy of it."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _mask_bytes(key_padding_mask):
    return None if key_padding_mask is None else key_padding_mask.contiguous().view(torch.uint8)


def _forward(q, k, v, key_padding_mask, rotary: bool, with_lse: bool):
    """K1 on checked inputs. Returns (out, lse or None, k_main), where k_main
    is the key matrix the main loop read: rot(k) when ``rotary``, else k."""
    b, h, t, s, d = q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    if q.device.type == "cpu":
        res = flash_attention_reference(q, k, v, key_padding_mask=key_padding_mask,
                                        rotary=rotary, return_lse=with_lse)
        out, lse = res if with_lse else (res, None)
        if rotary:
            cos, sin = rotary_tables(max(t, s), d, device=q.device)
            k = _rotate_f32(k, cos[:s], sin[:s])
        return out, lse, k
    _require_cuda_layout(q=q, k=k, v=v)
    fwd, _ = _libraries()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    cos = sin = k_rot = q_rot = None
    if rotary:
        cos, sin = _device_tables(max(t, s), d, q.device)
        k_rot = torch.empty_like(k)  # scratch: the kernel's prologue writes rot(k) here
        if q.dtype == torch.bfloat16:
            q_rot = torch.empty_like(q)  # and rot(q) (the fp32 kernel rotates q as it loads it)
    mask = _mask_bytes(key_padding_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd.esm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(cos), _ptr(sin),
            _ptr(k_rot), _ptr(q_rot), out.data_ptr(), _ptr(lse), b, h, t, s, d,
            int(q.dtype == torch.bfloat16), stream,
        )
    _raise_on(rc, fwd, "flash_attention")
    if with_lse:
        flash_attention_with_lse.launches += 1
    else:
        flash_attention.launches += 1
    return out, lse, (k if k_rot is None else k_rot)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    rotary: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (dq, dk, dv) of flash attention from the forward's ``out`` and
    ``lse`` (B, H, T) fp32 and the output cotangent ``do``. ``k`` is the key
    matrix the forward's main loop read (rot(k) when ``rotary``; dk is the
    gradient of the un-rotated k). The key set is the forward's, so ``k``/``v``
    may be a block of the keys when ``out``/``lse`` cover all of them: the
    results are then that block's exact partials (K5)."""
    b, h, t, s, d = _check(q, k, v, key_padding_mask)
    _check_grad_inputs(q, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             key_padding_mask=key_padding_mask, rotary=rotary)
    _require_cuda_layout(q=q, k=k, v=v, out=out, lse=lse, do=do)
    _, bwd = _libraries()
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    cos = sin = q_rot = None
    if rotary:
        cos, sin = _device_tables(max(t, s), d, q.device)
        q_rot = torch.empty_like(q)  # scratch: the dq pass's prologue writes rot(q) here
    mask = _mask_bytes(key_padding_mask)
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = bwd.esm_flash_attention_bwd_dq(
            q.data_ptr(), _ptr(q_rot), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(cos),
            _ptr(sin), out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, t, s, d, bf16, stream,
        )
        _raise_on(rc, bwd, "flash_attention_bwd (dq pass)")
        flash_attention_bwd.launches_dq += 1
        rc = bwd.esm_flash_attention_bwd_dkv(
            (q if q_rot is None else q_rot).data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            _ptr(cos), _ptr(sin), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, t, s, d, bf16, stream,
        )
        _raise_on(rc, bwd, "flash_attention_bwd (dk/dv pass)")
        flash_attention_bwd.launches_dkv += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (esm_tpu's ``_flash_core`` custom_vjp,
    :884-935): the forward is K1 writing the lse, the backward K2. The
    residuals are q, the key matrix K1's main loop read (rot(k) when rotary:
    the backward then rotates only q), v, out, lse and the mask, all through
    ``save_for_backward`` so that ``torch.utils.checkpoint`` can drop and
    recompute them."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, rotary):
        out, lse, k_main = _forward(q, k, v, key_padding_mask, rotary, with_lse=True)
        ctx.save_for_backward(q, k_main, v, out, lse, key_padding_mask)
        ctx.rotary = rotary
        return out

    @staticmethod
    def backward(ctx, do):
        q, k_main, v, out, lse, key_padding_mask = ctx.saved_tensors
        if do.device.type == "cuda":
            do = _dense(do)
        dq, dk, dv = flash_attention_bwd(q, k_main, v, out, lse, do,
                                         key_padding_mask=key_padding_mask,
                                         rotary=ctx.rotary)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
    rotary: bool = False,
) -> torch.Tensor:
    """Flash attention on (B, H, T, d) tensors; q must already be scaled.
    key_padding_mask: (B, S) bool, True at pads. ``rotary=True`` applies the
    GPT-NeoX rotary to q and k inside the kernel (position = row index).
    Returns (B, H, T, d) in q's dtype; differentiable in q, k and v."""
    _check(q, k, v, key_padding_mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_padding_mask, rotary)
    return _forward(q, k, v, key_padding_mask, rotary, with_lse=False)[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: flash attention that also returns the per-row log-sum-exp
    (B, H, T) fp32, no rotary: the residual that lets partial attention over
    key blocks combine exactly (ring attention). Not differentiable, as in
    esm_tpu. A row whose keys are all masked gets lse ~ -1e30."""
    _check(q, k, v, key_padding_mask)
    out, lse, _ = _forward(q, k, v, key_padding_mask, False, with_lse=True)
    return out, lse


def flash_attention_block_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: exact (dq, dk, dv) of attention against a key block (k/v (B, H, S,
    d) hold only some of the keys; ``key_padding_mask`` (B, S) is that block's)
    given the global ``out`` and ``lse`` from :func:`flash_attention_with_lse`:
    P = exp(q.k - lse) makes each block's backward an exact partial, and the
    partials sum over blocks (dq) or concatenate (dk, dv). No rotary."""
    return flash_attention_bwd(q, k, v, out, lse, do, key_padding_mask=key_padding_mask)


flash_attention.launches = 0           # K1 launches without the lse
flash_attention_with_lse.launches = 0  # K1 launches that write the lse
flash_attention_bwd.launches_dq = 0    # K2 dq passes (with delta and the rotary prologue)
flash_attention_bwd.launches_dkv = 0   # K2 dk/dv passes
