"""Key paths of a tree of tensors or arrays, as the checkpoints name them.

Copy of ``repro/checkpoint/checkpointer.py:36 _flatten_with_paths``: dict
keys in sorted order, NamedTuple fields by name (as JAX names them), list
and tuple items by index, joined by ``/``, e.g. ``0/encoder/0/wx`` or
``1/m/out_b`` for ``(params, AdamWState)``. Shared by the checkpointer and
by ``repro_torch.bridge``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs with JAX's key paths: dict keys in sorted order,
    NamedTuple fields by name, list and tuple items by index."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (str(key),))
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from _flatten(getattr(tree, field), prefix + (field,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """The leaves of ``tree`` with the paths of
    ``repro/checkpoint/checkpointer.py:36 _flatten_with_paths``, e.g.
    ``0/encoder/0/wx`` or ``1/m/out_b`` for ``(params, AdamWState)``."""
    return list(_flatten(tree))


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, the
    structure (and each mapping's key order) kept."""
    if isinstance(tree, Mapping):
        return {k: map_with_paths(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of ``arr``; a bfloat16 array (``ml_dtypes``', or
    the 2-byte void that ``np.save`` writes for one) comes back as bf16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))
