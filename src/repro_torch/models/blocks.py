"""Shared model building blocks of the port.

Counterparts of ``repro/models/blocks.py``. Parameters are dicts of
tensors (an ``nn.ParameterDict`` inside a module) with the JAX package's
names and layouts. Compute dtype follows the input; norms and RoPE work in
fp32 and cast back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to ±2σ, drawn in fp32 on
    ``device`` (the generator's device by default) and cast to ``dtype``.
    On the meta device it only makes the shape. Counterpart of
    ``repro/models/blocks.py:19 truncated_normal`` (another random stream)."""
    device = generator.device if device is None else device
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * out).to(dtype)


# -- norms --------------------------------------------------------------------


def init_norm(cfg, dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/blocks.py:28 init_norm``."""
    p = {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, population variance) in
    fp32. Counterpart of ``repro/models/blocks.py:42 apply_norm``."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6)
        return (out * p["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    centered = xf - mean
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    out = centered * torch.rsqrt(var + 1e-5)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# -- MLP (GLU or plain) ---------------------------------------------------------

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d CPU constant in ``like``'s dtype, as JAX rounds a weak-typed
    Python scalar to the array's dtype (a scalar on any device)."""
    return torch.tensor(value, dtype=like.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: fused in fp32; in bf16 written out as XLA runs it,
    x · 1/(1 + exp(−x)), each operation rounded to bf16."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form: fused in fp32; in bf16 written
    out as JAX does, each operation and constant rounded to bf16 (x³ as x ·
    x², its ``integer_pow``)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * (x * (x * x)))
    return x * (_const(0.5, x) * (1 + torch.tanh(inner)))


_ACTS = {"silu": _silu, "gelu": _gelu, "relu": F.relu}


def init_mlp(cfg, generator: torch.Generator, d_ff: int | None = None,
             dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/blocks.py:62 init_mlp``."""
    d_ff = d_ff or cfg.d_ff
    scale = cfg.init_scale / math.sqrt(cfg.d_model)

    def w(shape, s):
        return truncated_normal(shape, s, generator, dtype, device)

    p = {"down": w((d_ff, cfg.d_model), cfg.init_scale / math.sqrt(d_ff))}
    if cfg.glu:
        p["gate"] = w((cfg.d_model, d_ff), scale)
    p["up"] = w((cfg.d_model, d_ff), scale)
    return p


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Counterpart of ``repro/models/blocks.py:82 apply_mlp``."""
    act = _ACTS[cfg.act]
    if cfg.glu:
        h = act(x @ p["gate"]) * (x @ p["up"])
    else:
        h = act(x @ p["up"])
    return h @ p["down"]


# -- embedding / head -----------------------------------------------------------


def init_embed(cfg, generator: torch.Generator, dtype=torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    """Counterpart of ``repro/models/blocks.py:96 init_embed``."""
    p = {"embedding": truncated_normal((cfg.vocab_size, cfg.d_model), 1.0, generator,
                                       dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = truncated_normal((cfg.d_model, cfg.vocab_size),
                                        cfg.init_scale / math.sqrt(cfg.d_model),
                                        generator, dtype, device)
    return p


def _sqrt_d(cfg, like: torch.Tensor) -> torch.Tensor:
    """√d_model rounded to ``like``'s dtype, as ``jnp.asarray(np.sqrt(d), dtype)``:
    a 0-d CPU tensor, which PyTorch takes as a scalar on any device (no copy
    to the card, no wait for it)."""
    return torch.tensor(math.sqrt(cfg.d_model), dtype=like.dtype)


def embed_tokens(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Rows of the embedding times √d_model in the embedding's dtype.
    Counterpart of ``repro/models/blocks.py:113 embed_tokens``."""
    x = p["embedding"][tokens.long()]
    return x * _sqrt_d(cfg, x)


def lm_logits(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Counterpart of ``repro/models/blocks.py:118 lm_logits`` (a tied head
    divides by √d_model again)."""
    if cfg.tie_embeddings:
        return (x @ p["embedding"].T) / _sqrt_d(cfg, x)
    return x @ p["lm_head"]


# -- RoPE -------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """float64 inverse frequencies. Counterpart of
    ``repro/models/blocks.py:130 rope_frequencies``."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """fp32 frequencies on ``device``, made once: a copy to the card on
    every call would wait for the card twice per layer. Rounded to fp32 on
    the host, so that making it runs no operator on any device."""
    return torch.from_numpy(rope_frequencies(head_dim, theta).astype(np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x ``(..., seq, heads, head_dim)``; positions broadcastable to
    ``(..., seq)``. Rotates the two halves of the head (not interleaved
    pairs) in fp32. Counterpart of ``repro/models/blocks.py:134 apply_rope``."""
    freqs = _rope_table(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (..., s, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(half: int, sections: tuple[int, int, int], device: torch.device
                   ) -> torch.Tensor:
    """The position stream (0 t, 1 h, 2 w) of each of the ``half``
    frequency slots, on ``device``, made once."""
    sid = np.zeros(half, dtype=np.int64)
    sid[sections[0] : sections[0] + sections[1]] = 1
    sid[sections[0] + sections[1] :] = 2
    return torch.from_numpy(sid).to(device)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections: tuple[int, int, int],
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x ``(..., seq, heads, head_dim)``,
    ``positions_3d`` ``(3, ..., seq)`` (temporal, height, width streams);
    frequency slot i of the half head dim rotates by the stream
    ``sections`` gives it (the first ``sections[0]`` slots t, the next
    ``sections[1]`` h, the rest w). Equal streams reduce it to
    ``apply_rope``. Counterpart of ``repro/models/blocks.py:145 apply_mrope``."""
    half = x.shape[-1] // 2
    freqs = _rope_table(x.shape[-1], theta, x.device)  # (half,)
    pos = positions_3d[_mrope_streams(half, tuple(sections), positions_3d.device)]
    pos = torch.movedim(pos, 0, -1)  # (..., seq, half)
    angles = pos[..., None, :].to(torch.float32) * freqs  # (..., seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- loss -------------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over ``mask``, accumulated in fp32 and
    divided by max(Σmask, 1). Counterpart of
    ``repro/models/blocks.py:171 cross_entropy_loss``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
