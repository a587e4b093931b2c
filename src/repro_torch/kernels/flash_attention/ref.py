"""Plain PyTorch version of the flash-attention kernel.

Counterpart of ``repro/kernels/flash_attention/ref.py:12
flash_attention_ref`` extended by the two runtime arguments ``q_offset``
and ``kv_len``, which makes it ``repro/models/attention.py:97 sdpa`` as
``attend`` calls it. It works in the model layout ``(b, s, heads, hd)``:
fp32 scores divided by √hd, masked keys set to ``-1e30`` (a row that sees
no key gets a uniform softmax), fp32 softmax, probabilities cast to the
input dtype before ``p·v``. Query head ``h`` reads kv head
``h // (nq // nkv)``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """q ``(b, sq, nq, hd)``, k/v ``(b, skv, nkv, hd)`` -> ``(b, sq, nq, hd)``.
    Query row ``i`` sits at position ``q_offset + i``; keys at or past
    ``kv_len`` are masked."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    scores = torch.einsum("bsngk,btnk->bngst", qg.float(), k.float()) / math.sqrt(hd)

    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnk->bsngk", probs, v)
    return out.reshape(b, sq, nq, hd)
