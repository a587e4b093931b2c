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
            m={k: torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)
               for k, p in params.items()},
        )

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    def update(self, grads: Tree, state: AdamWState, params: Tree):
        """-> (new params, new state, the gradients' global norm before
        clipping, fp32 0-d)."""
        keys = list(params)
        g = [grads[k].float() for k in keys]
        gnorm = global_norm(g)
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
        return new_params, AdamWState(count, dict(zip(keys, m)), dict(zip(keys, v))), gnorm

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


def global_norm(tree: Tree | list[torch.Tensor]) -> torch.Tensor:
    """√(Σ over every leaf of Σ leaf²), fp32 0-d."""
    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    sums = [torch.sum(torch.square(leaf.float())) for leaf in leaves]
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
