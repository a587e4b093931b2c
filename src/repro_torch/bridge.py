"""Parameter exchange with the JAX package's parameter trees.

The JAX model keeps its parameters as a nested dict/list tree of arrays
(``repro/models/seq2seq.py:93 Seq2Seq.init``). Here a tree of numpy arrays
becomes ``{path: tensor}`` with the paths of
``repro/checkpoint/checkpointer.py:36 _flatten_with_paths`` (dict keys in
sorted order, list indices, joined by ``/``, e.g. ``encoder/0/wx``), and a
model or such a mapping turns back into the nested tree.

The LM's tree (``repro/models/lm.py:206 LM.init``) keeps its repeated
layers stacked under ``units/0/...`` with a leading ``n_units`` axis;
``lm_params_from_jax`` splits that axis into one ``layers/<i>/...`` entry
per layer and ``lm_params_to_jax`` stacks them back.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def from_jax_params(tree: Any) -> dict[str, torch.Tensor]:
    """``{"encoder/0/wx": tensor, ...}`` from a tree of numpy-convertible
    leaves (copied to CPU tensors)."""
    return {path: torch.from_numpy(np.array(leaf, copy=True)) for path, leaf in _flatten(tree)}


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
        node[leaf] = tensor.detach().cpu().numpy()
    return _nest(tree)


def lm_params_from_jax(tree: Mapping, cfg) -> dict[str, torch.Tensor]:
    """``{"embed/embedding": ..., "layers/0/attn/wq": ..., ...}`` from a
    JAX ``LM.init`` tree of an attention-only configuration (empty
    ``head`` and ``tail``, one stacked unit of ``cfg.n_layers`` layers)."""
    if tree["head"] or tree["tail"] or len(tree["units"]) != 1:
        raise ValueError("expected empty head/tail and a single stacked unit")
    out = from_jax_params({"embed": tree["embed"], "final_norm": tree["final_norm"]})
    for path, stacked in from_jax_params(tree["units"][0]).items():
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"units/0/{path} stacks {stacked.shape[0]} layers, "
                             f"expected {cfg.n_layers}")
        for i, layer in enumerate(stacked):
            out[f"layers/{i}/{path}"] = layer.clone()
    return out


def lm_params_to_jax(model: nn.Module) -> dict:
    """The JAX ``LM.init`` tree (numpy leaves) of a port ``LM``: its
    layers stacked back under ``units/0``, empty ``head`` and ``tail``."""
    rest: dict[str, torch.Tensor] = {}
    per_layer: dict[str, list[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        if path.startswith("layers/"):
            _, _, sub = path.split("/", 2)
            per_layer.setdefault(sub, []).append(p)  # named_parameters walks layers in order
        else:
            rest[path] = p
    tree = to_jax_params(rest)
    tree["units"] = [to_jax_params({sub: torch.stack(ts) for sub, ts in per_layer.items()})]
    tree["head"], tree["tail"] = [], []
    return tree
