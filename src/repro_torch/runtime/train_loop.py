"""The train step: value and gradient, microbatch accumulation, AdamW.

Copy of ``repro/runtime/train_loop.py``: ``TrainStepConfig`` (``:20``),
``split_microbatches`` (``:26``), ``make_input_pipeline`` (``:39``) and
``make_train_step`` (``:104``), which can also donate its params and
optimizer state (``donate=True``: updated in place).
``jax.value_and_grad`` becomes ``torch.autograd.grad`` over a loss that is
pure in its parameters (``functional_loss``: the model's ``loss`` run
with the given ``{path: tensor}`` in place of its own parameters, through
``torch.func.functional_call``; ``functional_decode`` runs ``decode_step``
so), and the microbatch ``lax.scan`` a loop
that sums fp32 gradients and divides by the count, as the reference's scan
body does. The config's ``loss_scale``, which the reference declares and
never reads, is left out.

Over DTensor parameters (an ``LM`` on a mesh) the step is the reference's
under ``pjit``: the loss is the mean over the global batch, each gradient
is redistributed to its parameter's placements (a parameter replicated
over the data axes gets the sum of the ranks' partial gradients, each of
which is already divided by the global count), the global-norm clip sums
over every shard and AdamW updates each rank's local shards. Microbatches
split each rank's own rows, so microbatch i is every rank's i-th part; the
step's mean loss and gradient are the global batch's either way.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
from torch import nn
from torch.func import functional_call

from ..optim.adamw import AdamW, AdamWState

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainStepConfig:
    n_microbatches: int = 1


def split_microbatches(batch: Mapping[str, torch.Tensor], n: int) -> list[dict]:
    """(B, ...) -> n batches of (B/n, ...) on every leaf; a DTensor leaf
    splits each rank's own rows, placed as the leaf."""
    from torch.distributed.tensor import DTensor

    out: list[dict] = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        if isinstance(x, DTensor):
            loc = x.to_local()
            shape = (b // n, *x.shape[1:])
            for i, part in enumerate(loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])
                                     .unbind(0)):
                out[i][k] = DTensor.from_local(part.contiguous(), x.device_mesh, x.placements,
                                               shape=shape,
                                               stride=torch.empty(shape, device="meta").stride())
            continue
        for i, part in enumerate(x.reshape(n, b // n, *x.shape[1:]).unbind(0)):
            out[i][k] = part
    return out


def make_input_pipeline(
    dataset,
    *,
    epochs: int | None = None,
    prefetch: int = 2,
    sharding: Any = None,
    stats: dict | None = None,
    overlap: bool = False,
    donate: bool = True,
    profiler: Any = None,
    device=None,
):
    """Wire a streaming :class:`~repro_torch.core.dataset.Dataset` into the
    learner: batches stream out of the dataset's shard executor through an
    :class:`~repro_torch.core.async_loader.AsyncLoader` that copies them to
    ``device`` (else the chain's ``.device(...)``, else the card) ahead of
    compute.
    Call ``.close()`` when training stops mid-epoch. ``stats`` (a dict)
    receives executor and cache counters after each epoch.

    ``overlap=True`` (or a ``profiler``) returns a
    :class:`~repro_torch.core.device_pipeline.DeviceFeed` instead: batches
    snap onto the plan's bucket grid, copies run one batch ahead, and the
    feed's profiler accounts host-wait against device-step time; wrap each
    step in ``feed.step(batch)``. PyTorch has no buffer donation, so
    ``donate`` donates nothing: it is the feed's guard that marks a stepped
    batch consumed, as the reference's donated buffers are. ``sharding``
    (a ``distributed.sharding.NamedSharding``) makes each rank copy its own
    rows of every batch and yields DTensors. Copy of
    ``repro/runtime/train_loop.py:39``."""
    from ..core.async_loader import AsyncLoader
    from ..device import resolve

    target = resolve(dataset._resolve_device(device))
    batches = dataset.iter_batches(epochs=epochs, stats=stats, device=device)
    if overlap or profiler is not None:
        from ..core.device_pipeline import DeviceFeed

        return DeviceFeed(
            batches,
            grid=dataset.bucket_grid_spec(),
            prefetch=prefetch,
            donate=donate,
            profiler=profiler,
            device=target,
            sharding=sharding,
        )
    return AsyncLoader(batches, prefetch=prefetch, sharding=sharding, device=target)


class _Method(nn.Module):
    """Calls one method of ``model`` as its forward, so that
    ``functional_call`` can swap the model's parameters for that call."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        return getattr(self.model, self.method)(*args)


def params_of(model: nn.Module) -> Params:
    """The model's parameters as ``{path: tensor}`` (detached), the tree
    that ``functional_loss``, ``AdamW`` and the checkpoints take."""
    return {name.replace(".", "/"): p.detach() for name, p in model.named_parameters()}


def _functional(model: nn.Module, method: str) -> Callable:
    wrapper = _Method(model, method)

    def call(params: Params, *args):
        named = {f"model.{path.replace('/', '.')}": t for path, t in params.items()}
        return functional_call(wrapper, named, args, strict=True)

    return call


def functional_loss(model: nn.Module) -> Callable[[Params, dict], torch.Tensor]:
    """``loss_fn(params, batch)``: ``model.loss(batch)`` computed with
    ``params`` (``{path: tensor}``) in place of the model's parameters; the
    model itself is left as it was."""
    return _functional(model, "loss")


def functional_decode(model: nn.Module) -> Callable:
    """``decode(params, tokens, state, pos) -> (logits, state)``:
    ``model.decode_step`` with ``params`` (on a mesh the DTensors of
    ``LM.distribute_params``) in place of the model's parameters, as the
    reference's jitted decode step takes them
    (``repro/launch/dryrun.py:270-290``); the model is left as it was."""
    return _functional(model, "decode_step")


def value_and_grad(loss_fn: Callable[[Params, dict], torch.Tensor]):
    """``(params, batch) -> (loss, {path: grad})``, the counterpart of
    ``jax.value_and_grad``: the loss detached, and a gradient for every
    parameter (zeros where the loss does not reach it)."""
    def fn(params: Params, batch):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad(), _replicate_plain(leaves):
            loss = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else _placed_as(g, p)
                 for (k, p), g in zip(leaves.items(), grads)}
        from ..distributed.sharding import full_value

        return full_value(loss.detach()), grads

    return fn


def _replicate_plain(params: Params):
    """Over DTensor parameters, a scope in which DTensor operators take a
    plain tensor (a position table, a constant the forward saved for the
    backward) as a replicated value; else no scope."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(p, DTensor) for p in params.values()):
        return contextlib.nullcontext()
    from ..launch.mesh import replicate_plain

    return replicate_plain()


def _placed_as(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements (a
    partial sum over the data axes becomes the sum); a plain one as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(param, DTensor) and grad.placements != param.placements:
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def make_train_step(
    loss_fn: Callable[[Params, dict], torch.Tensor],
    optimizer: AdamW,
    cfg: TrainStepConfig = TrainStepConfig(),
    *,
    donate: bool = False,
    grads_of: Callable[[Params, dict], tuple[torch.Tensor, Params]] | None = None,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics ``loss`` and ``grad_norm``, fp32 0-d tensors.

    By default the step is functional, as the reference's
    ``make_train_step`` is: new params and state, the arguments left as
    they were. With ``donate`` it is the counterpart of the reference
    launcher's ``jax.jit(step, donate_argnums=(0, 1))``: ``AdamW.update_``
    writes the new params and state into the tensors it was given (which
    the step returns) and drops each gradient as soon as its parameter is
    written, so no second copy of the trees is made. The values are the
    functional step's bit for bit. ``grads_of`` stands in for
    ``value_and_grad(loss_fn)``: the dry run (``launch/dryrun.py``) counts
    the first microbatch's and replays its count for the others."""
    grads_of = grads_of or value_and_grad(loss_fn)

    def train_step(params: Params, opt_state: AdamWState, batch):
        n = cfg.n_microbatches
        if n <= 1:
            loss, grads = grads_of(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            for mb in split_microbatches(batch, n):
                mb_loss, mb_grads = grads_of(params, mb)
                grads = {k: a + mb_grads[k].float() for k, a in grads.items()}
                loss = loss + mb_loss
            loss = loss / n
            grads = {k: g / n for k, g in grads.items()}
        if donate:
            gnorm = optimizer.update_(grads, opt_state, params)
            return params, opt_state, {"loss": loss.float(), "grad_norm": gnorm}
        new_params, new_opt, gnorm = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss.float(), "grad_norm": gnorm}

    return train_step
