"""Fine-grained Mixture-of-Experts (DeepSeekMoE / Kimi-K2 style).

Counterpart of ``repro/models/moe.py``, with the same names: routed
experts, top-k over an fp32 softmax with the DeepSeek renormalisation and
the Switch load-balance term, plus optional shared experts. Only the local
path (one device) is ported; expert parallelism (``moe_ep``, experts
sharded across cards with all-to-all exchanges) is ROADMAP.md Queue 1
item 6, and ``apply_moe`` refuses a mesh.

The reference computes the expert products with ``jax.lax.ragged_dot`` and
``einsum`` outside any Pallas kernel. Here ``impl="ragged"`` sorts the
token copies by expert and runs one ``torch.matmul`` per projection for
each expert that got tokens: reading the per-expert counts syncs the host
once per MoE layer (``HOST_SYNCS`` counts those reads and the seconds the
host waited in them). ``impl="batched"`` is the reference's capacity-bounded
form: a stable sort, an ``(E, cap, d)`` buffer filled in sorted order with
the copies past an expert's capacity dropped, and three batched products.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from .blocks import truncated_normal

HOST_SYNCS = {"count": 0, "seconds": 0.0}


def init_moe(cfg, generator: torch.Generator, dtype=torch.float32,
             device=None) -> dict:
    """Counterpart of ``repro/models/moe.py:36 init_moe``: ``router`` (d, E)
    in fp32, ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and, with
    shared experts, ``shared.{gate,up,down}`` of width ``n_shared · f``."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    s = cfg.init_scale / math.sqrt(d)

    def w(shape, scale, dt=dtype):
        return truncated_normal(shape, scale, generator, dt, device)

    p = {
        "router": w((d, m.n_experts), s, torch.float32),
        "w_gate": w((m.n_experts, d, f), s),
        "w_up": w((m.n_experts, d, f), s),
        "w_down": w((m.n_experts, f, d), cfg.init_scale / math.sqrt(f)),
    }
    if m.n_shared:
        fs = m.n_shared * f
        p["shared"] = {"gate": w((d, fs), s), "up": w((d, fs), s),
                       "down": w((fs, d), cfg.init_scale / math.sqrt(fs))}
    return p


def _route(xf: torch.Tensor, router: torch.Tensor, m):
    """Top-k routing of ``xf`` ``(N, d)`` -> (expert ids ``(N, k)``, their
    renormalised probabilities ``(N, k)`` in xf's dtype, the load-balance
    term ``E · Σ_e f_e · P_e`` (fp32 0-d)). Counterpart of
    ``repro/models/moe.py:75 _route``; a router in another dtype is cast to
    fp32, as JAX promotes ``fp32 @ bf16``."""
    logits = xf.float() @ router.float()  # (N, E)
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, m.top_k, dim=-1)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)  # renorm (DeepSeek)
    pe = probs_full.mean(0)
    fe = torch.bincount(ids.reshape(-1), minlength=m.n_experts).float()
    fe = fe / torch.clamp(fe.sum(), min=1.0)
    aux = m.n_experts * torch.sum(fe * pe)
    return ids, probs.to(xf.dtype), aux


def _glu(x, w_gate, w_up, w_down):
    """silu(x w_gate) · (x w_up) w_down, the gate's silu in fp32 as the
    reference casts it."""
    h = F.silu((x @ w_gate).float()).to(x.dtype) * (x @ w_up).to(x.dtype)
    return h @ w_down


def _expert_ffn(tokens: torch.Tensor, eids: torch.Tensor, p, n_experts: int,
                impl: str = "ragged", capacity_factor: float = 1.5) -> torch.Tensor:
    """Each row of ``tokens`` ``(m, d)`` through the GLU expert ``eids``
    names, in ``tokens``' order; ``eids == n_experts`` marks a padding row.
    Counterpart of ``repro/models/moe.py:90 _expert_ffn``.

    ``ragged``: exact (no dropping); a padding row goes through the last
    expert, as the reference clamps it. ``batched``: per expert at most
    ``cap = max(⌈m / E · capacity_factor⌉, 1)`` rows, taken in the order of
    a stable sort by expert; the rest, and padding rows, give zero."""
    m, d = tokens.shape
    if impl == "ragged":
        safe = torch.clamp(eids, max=n_experts - 1)
        order = torch.argsort(safe, stable=True)
        t0 = time.perf_counter()
        counts = torch.bincount(safe, minlength=n_experts).tolist()  # the host's one sync
        HOST_SYNCS["count"] += 1
        HOST_SYNCS["seconds"] += time.perf_counter() - t0
        sorted_tok = tokens[order]
        # unbind, not w[e]: the backward of E selections would build E
        # full-size zero gradients and add them; unbind's stacks once
        experts = zip(*(p[name].unbind(0) for name in ("w_gate", "w_up", "w_down")))
        outs, start = [], 0
        for n, (w_gate, w_up, w_down) in zip(counts, experts):
            if n:
                outs.append(_glu(sorted_tok[start : start + n], w_gate, w_up, w_down)
                            .to(tokens.dtype))
                start += n
        out = torch.cat(outs) if outs else tokens.new_zeros((0, d))
        return torch.zeros_like(out).index_copy(0, order, out)  # unsort

    if impl != "batched":
        raise ValueError(f"unknown expert impl {impl!r}")
    cap = max(int(math.ceil(m / n_experts * capacity_factor)), 1)
    order = torch.argsort(eids, stable=True)
    eid_s = eids[order]
    counts = torch.bincount(eid_s, minlength=n_experts + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=tokens.device) - starts[eid_s]
    valid = (pos < cap) & (eid_s < n_experts)
    buf = tokens.new_zeros((n_experts, cap, d)).index_put(
        (eid_s[valid], pos[valid]), tokens[order][valid])
    h = F.silu(torch.bmm(buf, p["w_gate"]).float()).to(tokens.dtype) * \
        torch.bmm(buf, p["w_up"]).to(tokens.dtype)
    out = torch.bmm(h, p["w_down"]).to(tokens.dtype)
    gathered = out[torch.clamp(eid_s, max=n_experts - 1), torch.clamp(pos, max=cap - 1)]
    gathered = torch.where(valid[:, None], gathered, 0.0)
    return torch.zeros_like(tokens).index_copy(0, order, gathered)


def moe_local(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over ``x`` ``(b, s, d)`` on one device -> (y,
    aux). Counterpart of ``repro/models/moe.py:144 moe_local``: the
    capacity factor is ``capacity_factor + 0.25`` as it passes it. Each
    token's k copies are contiguous, so in fp32 or fp64 their weighted sum
    is a reshape and a sum (the reference's scatter-add); in bf16 they are added
    one after another, each add rounded, as that scatter-add
    (``.at[tok_idx].add``) rounds them."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    ids, probs, aux = _route(xf, p["router"], m)
    n, k = ids.shape
    tok_idx = torch.arange(n, device=x.device).repeat_interleave(k)
    out_flat = _expert_ffn(xf[tok_idx], ids.reshape(-1), p, m.n_experts, impl=m.expert_impl,
                           capacity_factor=m.capacity_factor + 0.25)
    weighted = (out_flat * probs.reshape(-1)[:, None]).reshape(n, k, d)
    if x.dtype in (torch.float32, torch.float64):
        y = weighted.sum(1)
    else:
        y = weighted[:, 0]
        for j in range(1, k):
            y = y + weighted[:, j]
    return y.reshape(b, s, d), aux


def apply_moe(p, x: torch.Tensor, cfg, mesh=None, data_axes: tuple[str, ...] = (),
              model_axis: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """Routed plus shared experts -> (y, aux). Counterpart of
    ``repro/models/moe.py:263 apply_moe`` on one device."""
    if mesh is not None or model_axis or data_axes:
        raise NotImplementedError("apply_moe: expert parallelism over a mesh (moe_ep) is "
                                  "ROADMAP.md Queue 1 item 6; the port runs the local path")
    y, aux = moe_local(p, x, cfg)
    if cfg.moe.n_shared:
        sp = p["shared"]
        y = y + _glu(x, sp["gate"], sp["up"], sp["down"])
    return y, aux
