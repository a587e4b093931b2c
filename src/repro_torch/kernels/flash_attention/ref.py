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

For bf16 inputs the two training versions round where the bf16 kernels
(``csrc/flash_attention_train_bf16.cu``, ``csrc/flash_attention_bwd_bf16.cu``)
and the reference's bf16 attention round: every product sums exact
products of bf16 values in fp32; the scores Q·Kᵀ are rounded to bf16
before the scale (the reference's einsum returns them in bf16, ``sdpa``
and ``chunked_sdpa``); P is rounded to bf16 before P·V and
Pᵀ·dO (the reference's ``probs.astype(q.dtype)``); dP = dO·Vᵀ is rounded
to bf16 (its einsum's bf16 result), and D is the softmax's own sum Σ P·dP
(its VJP's), not rowsum(dO∘O) of a bf16 O; dS·scale is rounded to bf16
before dS·K and dSᵀ·Q (the transpose of its scores'
``.astype(jnp.float32)``); the softmax, lse and D stay in fp32, and out,
dq, dk and dv come out in bf16.
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


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to bf16 and back where the inputs are bf16."""
    return x.to(torch.bfloat16).float() if dtype == torch.bfloat16 else x


def _out(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An output in the inputs' dtype where they are bf16."""
    return x.to(torch.bfloat16) if dtype == torch.bfloat16 else x


def _scaled_scores(q, k, causal: bool, window: int, mm=torch.einsum):
    """Scores · 1/√hd ``(b, nkv, group, sq, skv)`` in fp32 (fp64 for fp64
    inputs; for bf16 inputs the scores are rounded to bf16 first), -inf
    where masked."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    qg = _real(q).reshape(b, sq, nkv, nq // nkv, hd)
    s = _rounded(mm("bsngk,btnk->bngst", qg, _real(k)), q.dtype) / math.sqrt(hd)
    return torch.where(_mask(sq, skv, causal, window, q.device), s, -math.inf)


def flash_attention_train_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              split_tf32: bool = False):
    """The forward of a training step, fp32 (fp64 for fp64 inputs, bf16 as
    the module's docstring says) -> (out ``(b, sq, nq, hd)`` in the inputs'
    dtype, lse ``(b, nq, sq)`` fp32, fp64 for fp64): lse is the log of each
    row's sum of exp(score · 1/√hd) over its visible keys. ``split_tf32`` runs
    the two products, Q Kᵀ and P V, as the kernel does (``split_einsum``)."""
    mm = split_einsum if split_tf32 else torch.einsum
    b, sq, nq, hd = q.shape
    s = _scaled_scores(q, k, causal, window, mm)
    lse = torch.logsumexp(s, dim=-1)  # (b, nkv, group, sq)
    p = _rounded(torch.exp(s - lse[..., None]), q.dtype)
    out = mm("bngst,btnk->bsngk", p, _real(v)).reshape(b, sq, nq, hd)
    return _out(out, q.dtype), lse.reshape(b, nq, sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            split_tf32: bool = False):
    """The backward of ``flash_attention_train_ref``, fp32 (fp64 for fp64
    inputs, bf16 as the module's docstring says) -> (dq, dk, dv) in the shapes and dtype of q,
    k, v. With P = exp(S·scale − lse) (0 where masked)
    and D = rowsum(dO∘O) (for bf16 Σ P·dP: out is not read, and may be None):
    dV = Σ Pᵀ dO, dS = P∘(dO Vᵀ − D),
    dQ = dS K·scale, dK = dSᵀ Q·scale; dK and dV sum over the query
    heads of each kv group. ``split_tf32`` runs the five products as the
    kernel does (``split_einsum``)."""
    mm = split_einsum if split_tf32 else torch.einsum
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    group = (b, sq, nkv, nq // nkv, hd)
    qg, dog = (_real(t).reshape(group) for t in (q, dout))
    kf, vf = _real(k), _real(v)
    p = torch.exp(_scaled_scores(q, k, causal, window, mm)
                  - _real(lse).reshape(b, nkv, nq // nkv, sq)[..., None])
    dv = mm("bngst,bsngk->btnk", _rounded(p, q.dtype), dog)
    dp = mm("bsngk,btnk->bngst", dog, vf)
    if q.dtype == torch.bfloat16:  # dP rounded, D the softmax's own sum of P dP
        dp = _rounded(dp, q.dtype)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        ds = _rounded(ds * scale, q.dtype)  # dS·scale rounded, as the scores' cast
        dq = mm("bngst,btnk->bsngk", ds, kf).reshape(b, sq, nq, hd)
        dk = mm("bngst,bsngk->btnk", ds, qg)
        return _out(dq, q.dtype), _out(dk, q.dtype), _out(dv, q.dtype)
    delta = torch.einsum("bsngk,bsngk->bngs", dog, _real(out).reshape(group))
    ds = p * (dp - delta[..., None])
    dq = mm("bngst,btnk->bsngk", ds, kf).reshape(b, sq, nq, hd) * scale
    dk = mm("bngst,bsngk->btnk", ds, qg) * scale
    return dq, dk, dv
