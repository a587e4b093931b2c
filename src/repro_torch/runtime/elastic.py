"""Elastic scaling: restore a tree onto a different topology.

Copy of ``repro/runtime/elastic.py``: ``available_mesh`` (``:31``) and
``remesh`` (``:46``). The checkpoint format is topology-independent
(whole host arrays keyed by tree path), so elasticity is a placement
problem: build the mesh over the ranks that are still alive, derive every
leaf's sharding with the same logical-axis rules, and place each leaf
again. The rule engine falls back per tensor when a dimension stops
dividing the new axis size, so shrinking needs no per-architecture code.

Every rank of the default process group calls both functions, in the
same order (building a mesh makes its process groups, which is
collective). A rank outside the new mesh gets the DTensors that
``torch.distributed.tensor`` gives a rank outside a mesh, with no local
data.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from ..distributed.sharding import (DEFAULT_RULES, NamedSharding, distribute, full_value,
                                   spec_for, tree_map_axes)


def available_mesh(model_parallel: int = 1, ranks: Sequence[int] | None = None):
    """The largest ``(data, model)`` mesh over ``ranks`` (every rank of the
    default group when None), the model axis lowered until it divides
    their count; on the cards under NCCL, else on the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    mp = model_parallel
    while n % mp:
        mp -= 1
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(n // mp, mp)
    return DeviceMesh(device_type, layout, mesh_dim_names=("data", "model"))


def remesh(tree: Any, axes_tree: Any, new_mesh, rules=DEFAULT_RULES) -> Any:
    """Every leaf of ``tree`` placed for ``new_mesh``: its whole value
    taken to each rank, then placed by the rules' sharding on the new mesh
    (each rank keeping its own block). Copy of
    ``repro/runtime/elastic.py:46 remesh``."""

    def one(x, axes):
        whole = full_value(x)
        return distribute(whole, NamedSharding(new_mesh, spec_for(whole.shape, axes, new_mesh,
                                                                  rules)))

    return tree_map_axes(one, tree, axes_tree)
