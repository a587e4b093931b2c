"""Multi-head attention: GQA, RoPE and M-RoPE, sliding window, KV cache.

Counterpart of ``repro/models/attention.py``. Every attention product is
``flash_attention_op``: the hand-written CUDA kernel on the card, its plain
version on the CPU. It stands where the JAX package calls ``sdpa`` or
``chunked_sdpa``, in all three uses of ``attend``: the full sequence
without a cache, block prefill into the cache at ``cache_pos = 0``, and a
one-token decode step at ``cache_pos = pos``; with a sliding window the
cache may be the ring of ``_ring_attend``. Under grad a full-sequence
call is differentiable through the kernel's backward; a call over the
cache (``q_offset`` or ``kv_len`` set) raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention_op
from .blocks import apply_mrope, apply_rope, truncated_normal


class KVCache(NamedTuple):
    """Counterpart of ``repro/models/attention.py:22 KVCache``."""

    k: torch.Tensor  # (batch, max_seq, n_kv_heads, head_dim)
    v: torch.Tensor


def init_attention(cfg, generator: torch.Generator, dtype=torch.float32,
                   device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/attention.py:27 init_attention``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = cfg.init_scale / math.sqrt(d)

    def w(shape, scale):
        return truncated_normal(shape, scale, generator, dtype, device)

    p = {
        "wq": w((d, nq, hd), s),
        "wk": w((d, nkv, hd), s),
        "wv": w((d, nkv, hd), s),
        "wo": w((nq, hd, d), cfg.init_scale / math.sqrt(nq * hd)),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg):
    """Counterpart of ``repro/models/attention.py:59 _project_qkv``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _rope(q, k, positions, cfg):
    """Counterpart of ``repro/models/attention.py:70 _rope``: ``rope``,
    ``mrope`` (Qwen2-VL's split of the half head dim into t, h and w
    sections of ``hd - 2·(hd//4)``, ``hd//4`` and ``hd//4`` slots) and
    ``none``."""
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        hd = cfg.resolved_head_dim // 2
        sections = (hd - 2 * (hd // 4), hd // 4, hd // 4)
        pos3 = mrope_positions(positions, cfg)
        q = apply_mrope(q, pos3, sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, sections, cfg.rope_theta)
    return q, k


def mrope_positions(positions: torch.Tensor, cfg) -> torch.Tensor:
    """``(3, b, s)`` temporal, height and width positions. Counterpart of
    ``repro/models/attention.py:84 mrope_positions``, with its rules: for
    the vision frontend every position below ``n_frontend_tokens`` lies on
    a √n grid (``grid = int(√n)``; t 0, h and w its row and column),
    whether or not the batch gave patches, and so does a short text prompt
    in ``decode_step``; the rest is text (t = h = w)."""
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    grid = max(int(np.sqrt(max(n_img, 1))), 1)
    is_img = positions < n_img
    h = torch.where(is_img, (positions % (grid * grid)) // grid, positions)
    w = torch.where(is_img, positions % grid, positions)
    t = torch.where(is_img, torch.zeros_like(positions), positions)
    return torch.stack([t, h, w])


def attend(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
           cache: KVCache | None = None, cache_pos: int = 0
           ) -> tuple[torch.Tensor, KVCache | None]:
    """The attention sub-layer. Counterpart of
    ``repro/models/attention.py:227 attend``.

    With ``cache`` set, ``x`` is the new block of tokens at positions
    ``cache_pos ...``: its keys and values are written into the cache IN
    PLACE (the returned cache holds the same tensors), and the block
    attends over the first ``cache_pos + len`` keys of the cache, read
    where they lie."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope(q, k, positions, cfg)
    if cache is None:
        out = flash_attention_op(q, k, v, causal=cfg.causal, window=cfg.window)
        new_cache = None
    elif cfg.window > 0 and cache.k.shape[1] <= cfg.window:
        out, new_cache = _ring_attend(q, k, v, cache, cache_pos, cfg)
    else:
        end = cache_pos + x.shape[1]
        if end > cache.k.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens at position {cache_pos} overflow a "
                             f"cache of {cache.k.shape[1]}")
        cache.k[:, cache_pos:end] = k.to(cache.k.dtype)
        cache.v[:, cache_pos:end] = v.to(cache.v.dtype)
        out = flash_attention_op(q, cache.k, cache.v, causal=cfg.causal, window=cfg.window,
                                 q_offset=cache_pos, kv_len=end)
        new_cache = cache
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


def _ring_attend(q, k, v, cache: KVCache, cache_pos: int, cfg):
    """The sliding-window ring-buffer cache of
    ``repro/models/attention.py:260 _ring_attend``: the cache holds only
    the last ``w`` keys, position P in slot P % w, written IN PLACE.

    A decode step reaches the ring through ``flash_attention_op`` without
    key positions. While ``cache_pos < w`` slot i holds position i, so the
    step attends like one over a linear cache (``q_offset=pos``,
    ``kv_len=pos + 1``, causal and windowed). From ``cache_pos >= w`` on
    every slot holds one of the last ``w <= window`` positions, all of them
    visible, so the step attends over all ``w`` slots with no mask. This is
    what the reference's ``k_positions`` mask gives (unwritten slots at
    negative positions).

    A block prefill attends within the block and writes its last ``w``
    tokens into the ring; the reference allows it at ``cache_pos == 0``
    only and would ignore the ring's earlier keys elsewhere, so the port
    raises on a block at ``cache_pos > 0``."""
    w = cache.k.shape[1]
    s = q.shape[1]
    if s == 1:
        slot = cache_pos % w
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        if cache_pos < w:
            out = flash_attention_op(q, cache.k, cache.v, causal=cfg.causal, window=cfg.window,
                                     q_offset=cache_pos, kv_len=cache_pos + 1)
        else:
            out = flash_attention_op(q, cache.k, cache.v, causal=False, window=0, kv_len=w)
        return out, cache
    if cache_pos != 0:
        raise NotImplementedError(
            f"a block of {s} tokens into the ring KV cache at position {cache_pos}: the "
            "reference attends within the block only, so the port allows a block prefill "
            "at position 0 alone (ROADMAP.md Queue 3)")
    out = flash_attention_op(q, k, v, causal=cfg.causal, window=cfg.window)
    take = min(w, s)
    slots = torch.arange(s - take, s, device=k.device) % w
    cache.k[:, slots] = k[:, s - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, s - take:].to(cache.v.dtype)
    return out, cache


def init_kv_cache(batch: int, max_seq: int, cfg, dtype=torch.float32,
                  device=None) -> KVCache:
    """Zeroed cache ``(batch, seq, n_kv_heads, head_dim)``. Counterpart of
    ``repro/models/attention.py:292 init_kv_cache``."""
    ring = cfg.window > 0 and cfg.ring_kv
    seq = min(max_seq, cfg.window) if ring else max_seq
    shape = (batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
