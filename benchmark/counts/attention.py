"""Operations and bytes of the attention kernels, and the least time the
card could take for them: the larger of operations at the bf16 peak and
bytes at the memory peak, each input read once and each output written once
(bf16 activations, fp32 biases and statistics)."""

from __future__ import annotations

from typing import Tuple

from . import peaks

BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.BYTES)


def k1(b: int, h: int, t: int, s: int, d: int) -> Tuple[float, float]:
    """Flash attention forward (K1) with rotary: (operations, bytes).
    q·kᵀ and p·v are 2·T·S·d each a head; q, k, v read and o written once,
    the key-padding mask and the fp32 rotary tables read once."""
    flops = 4 * b * h * t * s * d
    nbytes = (2 * b * h * t * d + 2 * b * h * s * d) * BF16 + b * s + 2 * max(t, s) * d * 4
    return flops, nbytes


def k2(b: int, h: int, t: int, s: int, d: int) -> Tuple[float, float]:
    """Flash attention backward (K2, the dq and dk/dv passes with the row
    dot): the five products of the backward, 10·T·S·d a head; q, k, v, o, do
    read and dq, dk, dv written once, the fp32 lse read once."""
    flops = 10 * b * h * t * s * d
    nbytes = 4 * b * h * t * d * BF16 + 4 * b * h * s * d * BF16 + b * h * t * 4 + b * s
    return flops, nbytes


def k6(b: int, i: int, j: int, h: int, d: int) -> Tuple[float, float]:
    """Triangle attention (K6): per row i and head, softmax(q·kᵀ + bias)·v
    over J keys; q, k, v read and o written once (bf16), the (B, H, J, J)
    fp32 triangle bias and the (B, I, J) fp32 mask bias read once."""
    flops = 4 * b * i * j * j * h * d
    nbytes = 4 * b * i * j * h * d * BF16 + b * h * j * j * 4 + b * i * j * 4
    return flops, nbytes
