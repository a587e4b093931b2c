"""Parameter exchange with the JAX package's parameter trees.

The JAX model keeps its parameters as a nested dict/list tree of arrays
(``repro/models/seq2seq.py:93 Seq2Seq.init``). Here a tree of numpy arrays
becomes ``{path: tensor}`` with the paths of
``repro/checkpoint/checkpointer.py:36 _flatten_with_paths`` (dict keys in
sorted order, list indices, joined by ``/``, e.g. ``encoder/0/wx``), and a
model or such a mapping turns back into the nested tree.
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
