"""int8 gradient compression with error feedback (1-bit-Adam lineage).

Copy of ``repro/optim/grad_compression.py``: ``quantize_int8`` (``:20``),
``dequantize_int8`` (``:26``), ``compress_tree`` (``:30``),
``decompress_tree`` (``:45``) and ``psum_compressed`` (``:49``). Gradients
are quantized to int8 with a per-tensor fp32 scale before the
cross-replica reduction and dequantized after; the quantization residual
is carried to the next step (error feedback). Trees are ``{path:
tensor}`` mappings. ``torch.round`` rounds half to even, as ``jnp.round``
does, so the quantization is the reference's bit for bit.

``psum_compressed`` runs on each rank's local gradients (plain tensors, or
the local shards of DTensors): the scales' max by ``all_reduce(MAX)`` in
fp32 over the groups given, then the int8 payloads summed as int32 by
``all_reduce(SUM)``, which is exact because every rank quantizes with the
shared scale. ``jax.lax.pmax``/``psum`` over mesh axis names become
all-reduces over those axes' process groups, one after another.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

Tree = Mapping[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 ``round(x / scale)`` clipped to ±127, fp32 0-d scale
    ``max|x| / 127 + 1e-12``)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _zeros(grads: Tree) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(g, dtype=torch.float32) for k, g in grads.items()}


def compress_tree(grads: Tree, error: Tree | None = None):
    """Quantize a gradient tree, folding in the carried error -> (int8
    tree, scales tree, new error tree)."""
    if error is None:
        error = _zeros(grads)
    corrected = {k: g.float() + error[k] for k, g in grads.items()}
    qs = {k: quantize_int8(c) for k, c in corrected.items()}
    q = {k: t[0] for k, t in qs.items()}
    s = {k: t[1] for k, t in qs.items()}
    new_error = {k: c - dequantize_int8(q[k], s[k]) for k, c in corrected.items()}
    return q, s, new_error


def decompress_tree(q: Tree, s: Tree) -> dict[str, torch.Tensor]:
    return {k: dequantize_int8(qq, s[k]) for k, qq in q.items()}


def _groups(group_or_axes) -> list:
    """Process groups: one group, a sequence of groups, or ``(mesh, axis
    names)`` for those axes' groups of a ``DeviceMesh``."""
    if isinstance(group_or_axes, tuple) and len(group_or_axes) == 2 and \
            hasattr(group_or_axes[0], "get_group"):
        mesh, axes = group_or_axes
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return [mesh.get_group(a) for a in axes]
    if isinstance(group_or_axes, (list, tuple)):
        return list(group_or_axes)
    return [group_or_axes]


def psum_compressed(grads: Tree, group_or_axes, error: Tree | None = None):
    """Error-feedback int8 all-reduce: quantize -> sum as int32 -> dequantize.
    -> (the dequantized sum over the ranks, the new error tree).

    The scales are max-combined across the ranks first, so the int8
    payloads share a scale and the int32 sum is exact."""
    groups = _groups(group_or_axes)
    if error is None:
        error = _zeros(grads)
    corrected = {k: g.float() + error[k] for k, g in grads.items()}
    scales = {k: torch.max(torch.abs(c)) / 127.0 + 1e-12 for k, c in corrected.items()}
    for s in scales.values():
        for g in groups:
            dist.all_reduce(s, op=dist.ReduceOp.MAX, group=g)
    q = {k: torch.clamp(torch.round(c / scales[k]), -127, 127).to(torch.int8)
         for k, c in corrected.items()}
    new_error = {k: c - q[k].to(torch.float32) * scales[k] for k, c in corrected.items()}
    summed = {k: qq.to(torch.int32) for k, qq in q.items()}
    for t in summed.values():
        for g in groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return {k: ss.to(torch.float32) * scales[k] for k, ss in summed.items()}, new_error
