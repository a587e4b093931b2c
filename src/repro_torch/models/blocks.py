"""Shared model building blocks of the port.

Counterparts of ``repro/models/blocks.py``. Parameters are dicts of
tensors (an ``nn.ParameterDict`` inside a module) with the JAX package's
names and layouts, and each ``*_axes`` function gives the logical axes of
its parameters, as the reference's do (``distributed/sharding.py`` maps
them to a mesh). Compute dtype follows the input; norms and RoPE work in
fp32 and cast back.

On a mesh the tensors are DTensors: the embedding of a vocabulary-sharded
table is ``F.embedding``, which gathers each rank's own rows and sums over
the model axis, and the cross entropy of vocabulary-sharded logits is
computed on each rank's own columns (``_vocab_parallel_nll``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..launch.mesh import is_dtensor


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


def norm_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/blocks.py:35 norm_axes``."""
    p = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        p["bias"] = ("embed",)
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


def mlp_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/blocks.py:75 mlp_axes``."""
    p = {"down": ("mlp", "embed"), "up": ("embed", "mlp")}
    if cfg.glu:
        p["gate"] = ("embed", "mlp")
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


def embed_axes(cfg) -> dict[str, tuple]:
    """Copy of ``repro/models/blocks.py:106 embed_axes``."""
    p = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["lm_head"] = ("embed", "vocab")
    return p


def _sqrt_d(cfg, like: torch.Tensor) -> torch.Tensor:
    """√d_model rounded to ``like``'s dtype, as ``jnp.asarray(np.sqrt(d), dtype)``:
    a 0-d CPU tensor, which PyTorch takes as a scalar on any device (no copy
    to the card, no wait for it)."""
    return torch.tensor(math.sqrt(cfg.d_model), dtype=like.dtype)


def embed_tokens(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Rows of the embedding times √d_model in the embedding's dtype.
    Counterpart of ``repro/models/blocks.py:113 embed_tokens``. A table
    sharded over a mesh (DTensor tokens and table) is read through
    ``F.embedding``: each rank looks up the rows it holds and the partial
    rows are summed, where indexing would gather the whole table."""
    table = p["embedding"]
    if _sharded(table):
        x = F.embedding(tokens.long(), table)
    else:
        x = table[tokens.long()]
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
    if is_dtensor(logits):
        return _vocab_parallel_nll(logits, targets, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _sharded(x) -> bool:
    """A DTensor split over some mesh dimension of more than one rank."""
    return is_dtensor(x) and any(
        p.is_shard() and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


class _SumOverGroup(torch.autograd.Function):
    """Sum over a process group whose result every rank then uses as the
    same (replicated) value: forward an all-reduce, backward the identity
    (each rank's input reaches the one replicated output once)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: no group, ``x`` itself), with the
    gradient of a replicated result (``_SumOverGroup``)."""
    return x if group is None else _SumOverGroup.apply(x, group)


def _vocab_parallel_nll(logits, targets, mask) -> torch.Tensor:
    """``cross_entropy_loss`` of DTensor logits ``(b, s, V)``, each rank on
    its own rows and vocabulary columns: the row max and Σ exp are reduced
    over the model axis, the gold logit is taken where a rank holds it and
    summed, and the rows' sum of −log p times ``mask`` over the data axes;
    no rank holds the whole logits. The mean divides by max(Σmask, 1) over
    the whole batch, as off the mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    import torch.distributed as dist

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    vocab = logits.shape[-1]
    lp, tp, outp = [], [], []
    for i, (name, pl) in enumerate(zip(names, logits.placements)):
        if name == "model" and mesh.size(i) > 1 and vocab % mesh.size(i) == 0:
            lp.append(Shard(logits.ndim - 1))
            tp.append(Replicate())
            outp.append(Replicate())
        elif pl.is_shard(0):
            lp.append(Shard(0))
            tp.append(Shard(0))
            outp.append(Partial())
        else:
            lp.append(Replicate())
            tp.append(Replicate())
            outp.append(Replicate())
    model = names.index("model") if "model" in names and lp[names.index("model")].is_shard() \
        else None
    group = mesh.get_group(model) if model is not None else None
    logits = logits.redistribute(mesh, lp)
    if not is_dtensor(targets):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim, run_check=False)
    targets = targets.redistribute(mesh, tp)
    if not is_dtensor(mask):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim, run_check=False)
    mask = mask.float().redistribute(mesh, tp)

    def local(lg, tg, mk):
        lg = lg.float()
        if group is None:  # every column here: the one-device operations
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, tg.long()[..., None])[..., 0]
            return torch.sum((logz - gold) * mk)
        lo = dist.get_rank(group) * lg.shape[-1]
        m = lg.detach().amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        sumexp = sum_over_group(torch.exp(lg - m[..., None]).sum(-1), group)
        logz = m + torch.log(sumexp)
        t = tg.long() - lo
        held = (t >= 0) & (t < lg.shape[-1])
        gold = torch.gather(lg, -1, torch.clamp(t, 0, lg.shape[-1] - 1)[..., None])[..., 0]
        gold = sum_over_group(torch.where(held, gold, 0.0), group)
        return torch.sum((logz - gold) * mk)

    from torch.distributed.tensor.experimental import local_map

    total = local_map(local, out_placements=outp, in_placements=(lp, tp, tp),
                      device_mesh=mesh)(logits, targets, mask)
    count = mask.sum().redistribute(mesh, [Replicate()] * mesh.ndim)
    return (total / torch.clamp(count, min=1.0)).redistribute(mesh, [Replicate()] * mesh.ndim)
