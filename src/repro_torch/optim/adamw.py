"""AdamW with decoupled weight decay and global-norm clipping.

Copy of ``repro/optim/adamw.py:1-86``: ``AdamWState`` (``:13``), ``AdamW``
(``:19``) with its ``init``/``update``, ``global_norm`` (``:70``) and
``warmup_cosine`` (``:77``). Trees are ``{path: tensor}`` mappings (the
paths of ``repro_torch.checkpoint.tree``); ``update`` returns new tensors
and leaves its arguments as they were, like the reference. ``update_`` is
the same step written into the tensors it is given, one tensor at a time:
the counterpart of the reference launcher's donated buffers
(``jax.jit(step, donate_argnums=(0, 1))``), so that a model whose params,
gradients and moments fill the card still takes a step. It is not
``torch.optim.AdamW``: the decay, the clipping and the state differ, and
checkpoints carry this state in the reference's layout.

The update keeps the reference's order of operations, each rounded in
fp32: clip the gradients by their global norm, then m and v, bias
correction with the incremented count, ``m̂ / (√v̂ + eps) + wd·p``, and
``p − lr(count)·step`` with the schedule read at the incremented count.
The ``torch._foreach_*`` calls do one operation each, so they round as the
reference's separate operations do; ``update_`` makes the same calls on
one-tensor lists, in the same order, so its results are ``update``'s bit
for bit.

Over DTensors (a model on a mesh) both update each rank's local shards of
the parameters, gradients (already placed as their parameters) and
moments with the same operations, and the global norm sums every leaf's
squares over its shards, so each element gets the one-device update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple

import torch

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32, 0-d
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # moments dtype: fp32 by default; bf16 halves the optimizer's memory
    moment_dtype: torch.dtype = torch.float32

    def init(self, params: Tree) -> AdamWState:
        device = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m={k: torch.zeros_like(p, dtype=self.moment_dtype) for k, p in params.items()},
            v={k: torch.zeros_like(p, dtype=self.moment_dtype) for k, p in params.items()},
        )

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    def update(self, grads: Tree, state: AdamWState, params: Tree):
        """-> (new params, new state, the gradients' global norm before
        clipping, fp32 0-d)."""
        keys = list(params)
        gnorm = global_norm([grads[k] for k in keys])
        shards = _Shards(params)
        params, grads = shards.local(params), shards.local(grads)
        state = AdamWState(state.count, shards.local(state.m), shards.local(state.v))
        g = [grads[k].float() for k in keys]
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            g = torch._foreach_mul(g, scale)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        md = self.moment_dtype
        m = torch._foreach_add(torch._foreach_mul([state.m[k].float() for k in keys], b1),
                               torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul([state.v[k].float() for k in keys], b2),
                               torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        m = [t.to(md) for t in m]
        v = [t.to(md) for t in v]
        c1 = 1 - torch.pow(b1, count.float())
        c2 = 1 - torch.pow(b2, count.float())
        lr = self._lr(count)
        p32 = [params[k].float() for k in keys]
        mhat = torch._foreach_div([t.float() for t in m], c1)
        vhat = torch._foreach_div([t.float() for t in v], c2)
        step = torch._foreach_add(
            torch._foreach_div(mhat, torch._foreach_add(torch._foreach_sqrt(vhat), self.eps)),
            torch._foreach_mul(p32, self.weight_decay))
        new = torch._foreach_sub(p32, torch._foreach_mul(step, lr))
        new_params = {k: t.to(params[k].dtype) for k, t in zip(keys, new)}
        return (shards.wrap(new_params),
                AdamWState(count, shards.wrap(dict(zip(keys, m))), shards.wrap(dict(zip(keys, v)))),
                gnorm)

    def update_(self, grads: dict[str, torch.Tensor], state: AdamWState,
                params: Tree) -> torch.Tensor:
        """``update`` in place: the new params, m, v and count are written
        into the tensors of ``params`` and ``state``, and the gradients'
        global norm before clipping (fp32 0-d) is returned. ``grads`` is
        consumed: an fp32 gradient is clipped in place, and each one leaves
        the dict as soon as its parameter is written, so that at most one
        tensor's temporaries stand beside the trees. Moments of another
        dtype are updated in fp32 and rounded into place, as ``update``
        rounds them."""
        keys = list(params)
        gnorm = global_norm([grads[k] for k in keys])
        shards = _Shards(params)
        params, local = shards.local(params), shards.local(grads)
        if local is not grads:  # consumed: the local dict holds them now
            grads.clear()
            grads = local
        state = AdamWState(state.count, shards.local(state.m), shards.local(state.v))
        scale = None
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        state.count.add_(1)
        b1, b2 = self.b1, self.b2
        c1 = 1 - torch.pow(b1, state.count.float())
        c2 = 1 - torch.pow(b2, state.count.float())
        lr = self._lr(state.count)
        for k in keys:
            g = [grads.pop(k).float()]
            if scale is not None:
                torch._foreach_mul_(g, scale)
            m, v, p = state.m[k], state.v[k], params[k]
            m32, v32, p32 = [m.float()], [v.float()], [p.float()]
            torch._foreach_mul_(m32, b1)
            torch._foreach_add_(m32, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v32, b2)
            gg = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(gg, g)
            torch._foreach_add_(v32, gg)
            del g, gg
            for moment, new in ((m, m32[0]), (v, v32[0])):
                if new is not moment:  # round into the moment's dtype
                    moment.copy_(new)
            step = torch._foreach_div([m.float()], c1)
            denom = torch._foreach_div([v.float()], c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(step, denom)
            del denom
            torch._foreach_add_(step, torch._foreach_mul(p32, self.weight_decay))
            torch._foreach_mul_(step, lr)
            torch._foreach_sub_(p32, step)
            if p32[0] is not p:
                p.copy_(p32[0])
        return gnorm


class _Shards:
    """The local shards of a tree whose leaves may be DTensors, and the
    way back: ``local`` gives each DTensor leaf's local tensor (the same
    storage, so in-place updates reach the DTensor), ``wrap`` makes new
    local tensors DTensors placed as the leaves were."""

    def __init__(self, like: Tree):
        from torch.distributed.tensor import DTensor

        self._like = {k: t for k, t in like.items() if isinstance(t, DTensor)}

    def local(self, tree: Tree):
        """``tree`` itself when no leaf is a DTensor, else a new dict."""
        if not self._like:
            return tree
        return {k: t.to_local() if k in self._like else t for k, t in tree.items()}

    def wrap(self, tree: Tree):
        if not self._like:
            return tree
        from torch.distributed.tensor import DTensor

        out = {}
        for k, t in tree.items():
            d = self._like.get(k)
            out[k] = t if d is None else DTensor.from_local(
                t, d.device_mesh, d.placements, shape=d.shape, stride=d.stride())
        return out


def global_norm(tree: Tree | list[torch.Tensor]) -> torch.Tensor:
    """√(Σ over every leaf of Σ leaf²), fp32 0-d. A DTensor leaf's sum of
    squares is its shards' summed over the mesh (a plain value on every
    rank): the local sums of the leaves split over the same mesh dimensions
    are stacked and reduced together, one reduction for each such set of
    dimensions rather than one for each leaf."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    sums: list = [None] * len(leaves)
    split: dict = {}  # (mesh, sharded mesh dims) -> indices of the leaves
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, DTensor):
            sums[i] = torch.sum(torch.square(leaf.float()))
            continue
        if any(p.is_partial() for p in leaf.placements):  # squares of a sum, not a sum
            leaf = leaf.redistribute(leaf.device_mesh, [Replicate() if p.is_partial() else p
                                                        for p in leaf.placements])
        sums[i] = torch.sum(torch.square(leaf.to_local().float()))
        dims = tuple(d for d, p in enumerate(leaf.placements) if p.is_shard())
        if dims:
            split.setdefault((leaf.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in split.items():
        partial = [Partial() if d in dims else Replicate() for d in range(mesh.ndim)]
        total = DTensor.from_local(torch.stack([sums[i] for i in idx]), mesh, partial,
                                   run_check=False).full_tensor()
        for j, i in enumerate(idx):
            sums[i] = total[j]
    return torch.sqrt(torch.stack(sums).sum())


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor ·
    peak_lr`` at ``total_steps``; a function of the step count, fp32."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = peak_lr * c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup_steps, warm, cos)

    return schedule
