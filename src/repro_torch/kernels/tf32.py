"""The tensor cores' fp32 arithmetic on the CPU: ``csrc/mma_tf32.cuh``'s
3xTF32 split, for the plain versions' ``split_tf32=True`` forms.

Each fp32 operand ``a`` is split into ``hi = tf32(a)`` and ``lo = tf32(a -
hi)`` (TF32's 10-bit mantissa, rounded to nearest, ties away from zero,
as ``cvt.rna.tf32``) and ``a·b = hi·hi′ + hi·lo′ + lo·hi′``: the low-low
product is dropped, and the small terms are summed first.
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10-bit mantissa, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); still fp32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of fp32 operands in 3xTF32: the low
    parts' products first, as the kernels accumulate them."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) \
        + torch.einsum(eq, a_hi, b_hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 operands in 3xTF32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
