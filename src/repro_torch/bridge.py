"""Parameter exchange with the JAX package's parameter trees.

The JAX model keeps its parameters as a nested dict/list tree of arrays
(``repro/models/seq2seq.py:93 Seq2Seq.init``). Here a tree of numpy arrays
becomes ``{path: tensor}`` with the paths of
``repro/checkpoint/checkpointer.py:36 _flatten_with_paths`` (dict keys in
sorted order, list indices, joined by ``/``, e.g. ``encoder/0/wx``), and a
model or such a mapping turns back into the nested tree.

The LM's tree (``repro/models/lm.py:206 LM.init``) keeps its unrolled
leading layers under ``head/<h>/...`` (a MoE configuration's
``first_k_dense`` dense layers; empty otherwise), one stacked tree per
position of the block pattern under ``units/<j>/...``, each with a leading
``n_units`` axis, and the unrolled remainder under ``tail/<t>/...``.
``lm_params_from_jax`` turns them into one ``layers/<i>/...`` entry per
layer (``head[h]`` is layer h; position j of unit u is layer
``n_head + u·len(pattern) + j``; ``tail[t]`` follows the units) and
``lm_params_to_jax`` stacks them back. A MoE layer's ``moe`` subtree keeps
its paths (``moe/router``, ``moe/w_gate``, ``moe/shared/gate``, ...), and so
does a frontend's projection (``frontend/proj``).

The optimizer state crosses too (``adamw_state_from_jax``,
``adamw_state_to_jax``). The key paths are the checkpoint's
(``checkpoint/tree.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .checkpoint.tree import flatten_with_paths, tensor_from_numpy
from .optim.adamw import AdamWState


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; bf16 as numpy's ``bfloat16``, which exists
    only where ``ml_dtypes`` (JAX's) has registered it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy().copy()


def from_jax_params(tree: Any) -> dict[str, torch.Tensor]:
    """``{"encoder/0/wx": tensor, ...}`` from a tree of numpy-convertible
    leaves (copied to CPU tensors)."""
    return {path: tensor_from_numpy(leaf) for path, leaf in flatten_with_paths(tree)}


def _nest(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _nest(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def to_jax_params(params: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """Nested dict/list tree of numpy arrays, the layout of ``Seq2Seq.init``,
    from a module's parameters or from a ``{path: tensor}`` mapping."""
    if isinstance(params, nn.Module):
        params = {name.replace(".", "/"): p for name, p in params.named_parameters()}
    tree: dict = {}
    for path, tensor in params.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = tensor_to_numpy(tensor)
    return _nest(tree)


def adamw_state_from_jax(state) -> AdamWState:
    """The port's ``AdamWState`` (CPU tensors; ``count`` int32 0-d) from the
    JAX package's (``repro/optim/adamw.py:13``), or any ``(count, m, v)``
    of numpy-convertible leaves."""
    count, m, v = state
    return AdamWState(torch.from_numpy(np.array(count, dtype=np.int32)),
                      from_jax_params(m), from_jax_params(v))


def adamw_state_to_jax(state: AdamWState) -> AdamWState:
    """``(count, m, v)`` as numpy trees in the layout of ``Seq2Seq.init``
    (``count`` an int32 0-d array), ready for the JAX ``AdamWState(*...)``."""
    return AdamWState(state.count.detach().cpu().numpy().astype(np.int32),
                      to_jax_params(state.m), to_jax_params(state.v))


def _layout(cfg) -> tuple[int, int, int, int]:
    """(head layers, pattern length, stacked units, tail layers) of the JAX
    ``LM``: a MoE configuration's ``first_k_dense`` layers make the head
    and the rest one stacked unit of period 1."""
    if cfg.moe is not None:
        k = cfg.moe.first_k_dense
        return k, 1, cfg.n_layers - k, 0
    period = len(cfg.block_pattern)
    n_units, n_tail = divmod(cfg.n_layers, period)
    return 0, period, n_units, n_tail


def lm_params_from_jax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """``{"embed/embedding": ..., "layers/0/attn/wq": ..., ...}`` from a
    JAX ``LM.init`` tree: ``head[h]`` is layer h, position j of stacked unit
    u is layer ``n_head + u·period + j``, then the tail; a frontend's
    ``frontend/proj`` keeps its path."""
    n_head, period, n_units, n_tail = _layout(cfg)
    if len(tree["head"]) != n_head or len(tree["units"]) != period or \
            len(tree["tail"]) != n_tail:
        raise ValueError(f"expected {n_head} head layers, {period} stacked units and {n_tail} "
                         f"tail layers")
    out = from_jax_params({k: tree[k] for k in ("embed", "frontend", "final_norm") if k in tree})
    for h, block in enumerate(tree["head"]):
        for path, leaf in from_jax_params(block).items():
            out[f"layers/{h}/{path}"] = leaf
    for j, unit in enumerate(tree["units"]):
        for path, stacked in from_jax_params(unit).items():
            if stacked.shape[0] != n_units:
                raise ValueError(f"units/{j}/{path} stacks {stacked.shape[0]} layers, "
                                 f"expected {n_units}")
            for u, layer in enumerate(stacked):
                out[f"layers/{n_head + u * period + j}/{path}"] = layer.clone()
    for t, block in enumerate(tree["tail"]):
        for path, leaf in from_jax_params(block).items():
            out[f"layers/{n_head + n_units * period + t}/{path}"] = leaf
    return out


def lm_params_to_jax(model: nn.Module) -> dict:
    """The JAX ``LM.init`` tree (numpy leaves) of a port ``LM``: its
    layers back under ``head``, stacked under ``units/<j>`` and ``tail``."""
    n_head, period, n_units, n_tail = _layout(model.cfg)
    rest: dict[str, torch.Tensor] = {}
    layers: list[dict[str, torch.Tensor]] = [{} for _ in range(model.cfg.n_layers)]
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        if path.startswith("layers/"):
            _, i, sub = path.split("/", 2)
            layers[int(i)][sub] = p
        else:
            rest[path] = p
    tree = to_jax_params(rest)
    tree["head"] = [to_jax_params(layers[h]) for h in range(n_head)]
    tree["units"] = [
        to_jax_params({sub: torch.stack([layers[n_head + u * period + j][sub]
                                         for u in range(n_units)])
                       for sub in layers[n_head + j]})
        for j in range(period)
    ]
    tree["tail"] = [to_jax_params(layers[n_head + n_units * period + t]) for t in range(n_tail)]
    return tree
