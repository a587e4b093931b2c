"""Fine-grained Mixture-of-Experts (DeepSeekMoE / Kimi-K2 style).

Counterpart of ``repro/models/moe.py``, with the same names: routed
experts, top-k over an fp32 softmax with the DeepSeek renormalisation and
the Switch load-balance term, plus optional shared experts. Two paths,
as in the reference: ``moe_local`` on one device, and the expert-parallel
``moe_ep`` over a mesh, the experts sharded over the model axis, each data
shard routing its own tokens into capacity-bounded send buffers that an
``all_to_all_single`` over the model axis's group exchanges (forward and
backward), the expert GLU on each rank's expert slice, and the reverse
exchange before the weighted combine. ``apply_moe`` takes ``moe_ep`` where
the reference's ``use_ep`` does (a model axis above 1 that divides the
experts), else ``moe_local``, on a mesh on each data shard with the
load-balance statistics of the whole batch.

The reference computes the expert products with ``jax.lax.ragged_dot`` and
``einsum`` outside any Pallas kernel. Here ``impl="ragged"`` sorts the
token copies by expert and runs one ``torch.matmul`` per projection for
each expert that got tokens: reading the per-expert counts syncs the host
once per MoE layer (``HOST_SYNCS`` counts those reads and the seconds the
host waited in them). ``impl="batched"`` is the reference's capacity-bounded
form: a stable sort, an ``(E, cap, d)`` buffer filled in sorted order with
the copies past an expert's capacity dropped, and three batched products.

On the meta device (the dry run, ``launch/dryrun.py``) the counts cannot
be read. The ragged path then takes the routing that hits the most
experts a layer can hit, ``min(E, m)`` of them for ``m`` token copies,
with the rows split evenly (``meta_counts``). Its FLOPs are the card's
whatever the routing, since the three products take all ``m`` rows. Its
bytes are the most any routing moves, since every expert hit reads its
weights and adds its slice's terms; ``kernels/cost.record`` adds the
count that the card reads back. The batched path's capacity mask has a
shape that depends on the routing, so it does not run on meta.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import cost
from .blocks import sum_over_group, truncated_normal

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


def moe_axes(cfg) -> dict:
    """Copy of ``repro/models/moe.py:58 moe_axes``."""
    p = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }
    if cfg.moe.n_shared:
        p["shared"] = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"), "down": ("mlp", "embed")}
    return p


def _route(xf: torch.Tensor, router: torch.Tensor, m):
    """Top-k routing of ``xf`` ``(N, d)`` -> (expert ids ``(N, k)``, their
    renormalised probabilities ``(N, k)`` in xf's dtype, the load-balance
    term ``E · Σ_e f_e · P_e`` (fp32 0-d)). Counterpart of
    ``repro/models/moe.py:75 _route``; a router in another dtype is cast to
    fp32, as JAX promotes ``fp32 @ bf16``."""
    ids, probs, pe, fe = _route_stats(xf, router, m)
    fe = fe / torch.clamp(fe.sum(), min=1.0)
    aux = m.n_experts * torch.sum(fe * pe)
    return ids, probs, aux


def _route_stats(xf: torch.Tensor, router: torch.Tensor, m):
    """``_route``'s expert ids and probabilities, the mean router
    probability of each expert ``pe`` and its count of assignments ``fe``
    (fp32, unnormalised)."""
    logits = xf.float() @ router.float()  # (N, E)
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, m.top_k, dim=-1)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)  # renorm (DeepSeek)
    pe = probs_full.mean(0)
    fe = bincount(ids.reshape(-1), m.n_experts).float()
    return ids, probs.to(xf.dtype), pe, fe


def bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` of ids below ``n``; on the meta
    device an empty int64 ``(n,)`` whose bytes are recorded as the
    operator's (its input and its result)."""
    if ids.device.type != "meta":
        return torch.bincount(ids, minlength=n)
    out = torch.empty((n,), dtype=torch.int64, device=ids.device)
    cost.record(moved=cost.nbytes(ids, out))
    return out


def meta_counts(ids: torch.Tensor, n_experts: int) -> list[int]:
    """Rows per expert on the meta device for the ``m`` ids: the first
    ``min(E, m)`` experts hit, the rows split evenly. Records the bytes
    of the bincount the card reads back."""
    bincount(ids, n_experts)  # records the count's bytes
    m = ids.numel()
    hit = min(n_experts, m)
    return [m // hit + (e < m % hit) if e < hit else 0 for e in range(n_experts)]


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
        if tokens.device.type == "meta":
            counts = meta_counts(safe, n_experts)
        else:
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
    counts = bincount(eid_s, n_experts + 1)
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


def moe_local(p, x: torch.Tensor, cfg, *, data_groups: tuple = ()
              ) -> tuple[torch.Tensor, torch.Tensor]:
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
    if data_groups:  # one data shard of the batch: the statistics of all of it
        ids, probs, pe, fe = _route_stats(xf, p["router"], m)
        ranks = 1
        for g in data_groups:
            pe, fe = sum_over_group(pe, g), sum_over_group(fe, g)
            ranks *= dist.get_world_size(g)
        fe = fe / torch.clamp(fe.sum(), min=1.0)
        aux = m.n_experts * torch.sum(fe * (pe / ranks))
    else:
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


def _groups(mesh, axes) -> tuple:
    return tuple(mesh.get_group(a) for a in axes)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _moe_ep_body(router, w_gate, w_up, w_down, x, cfg, model_group, data_groups):
    """The per-rank body of ``moe_ep`` on local tensors: ``x`` ``(b_loc, s,
    d)`` one data shard, the expert weights this rank's slice of ``E /
    n_shards`` experts. Copy of ``repro/models/moe.py:167 _moe_ep_body``."""
    from torch.distributed.nn.functional import all_to_all_single

    m = cfg.moe
    n_shards = dist.get_world_size(model_group)
    e_loc = m.n_experts // n_shards
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]

    ids, probs, aux = _route(xf, router, m)
    flat_ids = ids.reshape(-1)  # (n*k,)
    tok_idx = torch.arange(n, device=x.device).repeat_interleave(m.top_k)
    owner = flat_ids // e_loc

    cap = int(math.ceil(n * m.top_k / n_shards * m.capacity_factor))
    # sort assignments by owner; position within owner group
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    counts = torch.bincount(owner_s, minlength=n_shards)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * m.top_k, device=x.device) - starts[owner_s]
    valid = pos < cap
    # capacity-bounded scatter into per-owner send buffers (overflow dropped)
    at = (owner_s[valid], pos[valid])
    send_tok = xf.new_zeros((n_shards, cap, d)).index_put(at, xf[tok_idx[order]][valid])
    # padding slots carry the trash expert id e_loc
    send_eid = torch.full((n_shards, cap), e_loc, dtype=torch.int64, device=x.device)
    send_eid = send_eid.index_put(at, (flat_ids[order] % e_loc)[valid])

    # exchange: recv[j] = what peer j sent to me
    recv_tok = all_to_all_single(torch.empty_like(send_tok), send_tok, group=model_group)
    recv_eid = torch.empty_like(send_eid)
    dist.all_to_all_single(recv_eid, send_eid, group=model_group)

    # Every model rank of a data shard routes the same tokens, so each
    # expert slice computes n_shards copies of one result; the copies'
    # gradients add up, and 1/n_shards makes their sum the one result's.
    w = {name: _ScaleGrad.apply(t, 1.0 / n_shards)
         for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down))}
    out = _expert_ffn(recv_tok.reshape(-1, d), recv_eid.reshape(-1), w, e_loc,
                      impl=m.expert_impl, capacity_factor=m.capacity_factor + 0.25)
    out = out.reshape(n_shards, cap, d)

    # reverse exchange and weighted combine
    back = all_to_all_single(torch.empty_like(out), out.contiguous(), group=model_group)
    wts = torch.where(valid, probs.reshape(-1)[order], 0).to(x.dtype)
    gathered = back[torch.clamp(owner_s, 0, n_shards - 1), torch.clamp(pos, max=cap - 1)]
    y = torch.zeros_like(xf).index_add(0, tok_idx[order], gathered * wts[:, None])

    ranks = 1
    for g in data_groups:  # pmean over the data axes
        aux = sum_over_group(aux, g)
        ranks *= dist.get_world_size(g)
    return y.reshape(b, s, d), aux / ranks


def moe_ep(p, x, cfg, mesh, data_axes: tuple[str, ...], model_axis: str):
    """The expert-parallel MoE over ``mesh``: ``x`` a DTensor ``(b, s, d)``
    (rows over ``data_axes``, replicated over ``model_axis``) -> (y placed
    as ``x``, aux replicated). Counterpart of ``repro/models/moe.py:229
    moe_ep``: the body runs on each rank's local tensors (``local_map``),
    the experts ``Shard(0)`` over ``model_axis``, the router replicated;
    the weights' gradients are partial sums over the data axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..launch.mesh import shard_map

    names = mesh.mesh_dim_names
    dp = tuple(data_axes)

    def pl(model, data):
        return [model if a == model_axis else data if a in dp else Replicate() for a in names]

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    x_pl = pl(Replicate(), Shard(0))
    rep, rep_grad = pl(Replicate(), Replicate()), pl(Replicate(), Partial())
    ex, ex_grad = pl(Shard(0), Replicate()), pl(Shard(0), Partial())
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
    fn = shard_map(
        lambda *a: _moe_ep_body(*a, cfg=cfg, model_group=mesh.get_group(model_axis),
                                data_groups=_groups(mesh, dp)),
        mesh=mesh, in_specs=(rep, ex, ex, ex, x_pl), out_specs=(x_pl, rep),
        in_grad_specs=(rep_grad, ex_grad, ex_grad, ex_grad, x_pl),
        redistribute_inputs=True)
    return fn(*args)


def _moe_local_on_mesh(p, x, cfg, mesh, data_axes):
    """``moe_local`` on each data shard of a DTensor ``x``, the routed
    weights replicated; the load-balance term over the whole batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..launch.mesh import shard_map

    names = mesh.mesh_dim_names
    x_pl = [Shard(0) if a in data_axes and pl.is_shard(0) else Replicate()
            for a, pl in zip(names, x.placements)]
    sharded = tuple(a for a, pl in zip(names, x_pl) if pl.is_shard())
    rep = [Replicate()] * mesh.ndim
    rep_grad = [Partial() if a in sharded else Replicate() for a in names]
    keys = ("router", "w_gate", "w_up", "w_down")

    def body(*a):
        return moe_local(dict(zip(keys, a[:4])), a[4], cfg, data_groups=_groups(mesh, sharded))

    fn = shard_map(body, mesh=mesh, in_specs=(rep,) * 4 + (x_pl,), out_specs=(x_pl, rep),
                   in_grad_specs=(rep_grad,) * 4 + (x_pl,), redistribute_inputs=True)
    return fn(*(p[k] for k in keys), x)


def apply_moe(p, x: torch.Tensor, cfg, mesh=None, data_axes: tuple[str, ...] = (),
              model_axis: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """Routed plus shared experts -> (y, aux). Copy of
    ``repro/models/moe.py:256 apply_moe``: ``moe_ep`` where the model axis
    is above 1 and divides the experts, else ``moe_local`` (on each data
    shard of a mesh)."""
    m = cfg.moe
    size = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {}
    use_ep = bool(model_axis) and size.get(model_axis, 1) > 1 and \
        m.n_experts % size[model_axis] == 0
    if use_ep:
        y, aux = moe_ep(p, x, cfg, mesh, data_axes, model_axis)
    elif mesh is not None:
        y, aux = _moe_local_on_mesh(p, x, cfg, mesh, tuple(data_axes))
    else:
        y, aux = moe_local(p, x, cfg)
    if cfg.moe.n_shared:
        sp = p["shared"]
        y = y + _glu(x, sp["gate"], sp["up"], sp["down"])
    return y, aux
