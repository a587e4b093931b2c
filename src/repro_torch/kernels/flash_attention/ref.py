"""Plain PyTorch version of the flash-attention kernel.

Counterpart of ``repro/kernels/flash_attention/ref.py:12
flash_attention_ref`` extended by the two runtime arguments ``q_offset``
and ``kv_len``, which makes it ``repro/models/attention.py:97 sdpa`` as
``attend`` calls it. It works in the model layout ``(b, s, heads, hd)``:
fp32 scores divided by √hd, masked keys set to ``-1e30`` (a row that sees
no key gets a uniform softmax), fp32 softmax, probabilities cast to the
input dtype before ``p·v``. Query head ``h`` reads kv head
``h // (nq // nkv)``.

``flash_attention_train_ref`` and ``flash_attention_bwd_ref`` are the
plain versions of the training forward (``csrc/flash_attention_train.cu``)
and of the backward kernel (``csrc/flash_attention_bwd.cu``), fp32 over a full sequence (query ``i``
at position ``i``): the forward also returns each row's log-sum-exp, and
the backward writes the softmax's gradient out, as the kernel computes it,
not through autograd. With ``split_tf32=True`` the training forward's two
matrix products and the backward's five are computed as the kernels'
tensor cores compute them (``csrc/flash_attention_train.cu``,
``csrc/flash_attention_bwd.cu``; ``kernels/tf32.py``: each fp32 operand
``a`` split into ``hi = tf32(a)`` and ``lo = tf32(a - hi)``, and ``a·b =
hi·hi′ + hi·lo′ + lo·hi′``).
"""

from __future__ import annotations

import math

import torch

from ..tf32 import split_einsum, tf32  # noqa: F401  (tf32 re-exported)

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


def _mask(sq: int, skv: int, causal: bool, window: int, device) -> torch.Tensor:
    """(sq, skv): True where query position i sees key j."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _real(x: torch.Tensor) -> torch.Tensor:
    """fp32, or fp64 where given (a yardstick of the fp32 versions)."""
    return x if x.dtype == torch.float64 else x.float()


def _scaled_scores(q, k, causal: bool, window: int, mm=torch.einsum):
    """Scores · 1/√hd ``(b, nkv, group, sq, skv)`` in fp32 (fp64 for fp64
    inputs), -inf where masked."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = _real(q).reshape(b, sq, nkv, nq // nkv, hd)
    s = mm("bsngk,btnk->bngst", qg, _real(k)) / math.sqrt(hd)
    return torch.where(_mask(sq, skv, causal, window, q.device), s, -math.inf)


def flash_attention_train_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              split_tf32: bool = False):
    """The forward of a training step, fp32 (fp64 for fp64 inputs) -> (out
    ``(b, sq, nq, hd)``, lse ``(b, nq, sq)``): lse is the log of each row's
    sum of exp(score · 1/√hd) over its visible keys. ``split_tf32`` runs
    the two products, Q Kᵀ and P V, as the kernel does (``split_einsum``)."""
    mm = split_einsum if split_tf32 else torch.einsum
    b, sq, nq, hd = q.shape
    s = _scaled_scores(q, k, causal, window, mm)
    lse = torch.logsumexp(s, dim=-1)  # (b, nkv, group, sq)
    p = torch.exp(s - lse[..., None])
    out = mm("bngst,btnk->bsngk", p, _real(v)).reshape(b, sq, nq, hd)
    return out, lse.reshape(b, nq, sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            split_tf32: bool = False):
    """The backward of ``flash_attention_train_ref``, fp32 -> (dq, dk, dv)
    in the shapes of q, k, v. With P = exp(S·scale − lse) (0 where masked)
    and D = rowsum(dO∘O): dV = Σ Pᵀ dO, dS = P∘(dO Vᵀ − D),
    dQ = dS K·scale, dK = dSᵀ Q·scale; dK and dV sum over the query
    heads of each kv group. ``split_tf32`` runs the five products as the
    kernel does (``split_einsum``)."""
    mm = split_einsum if split_tf32 else torch.einsum
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    group = (b, sq, nkv, nq // nkv, hd)
    qg, og, dog = (t.float().reshape(group) for t in (q, out, dout))
    kf, vf = k.float(), v.float()
    p = torch.exp(_scaled_scores(q, k, causal, window, mm)
                  - lse.float().reshape(b, nkv, nq // nkv, sq)[..., None])
    delta = torch.einsum("bsngk,bsngk->bngs", dog, og)
    dv = mm("bngst,bsngk->btnk", p, dog)
    dp = mm("bsngk,btnk->bngst", dog, vf)
    ds = p * (dp - delta[..., None])
    dq = mm("bngst,btnk->bsngk", ds, kf).reshape(b, sq, nq, hd) * scale
    dk = mm("bngst,bsngk->btnk", ds, qg) * scale
    return dq, dk, dv
