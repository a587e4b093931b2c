"""Logical-axis sharding rule engine of the port.

Copy of ``repro/distributed/sharding.py``: ``DEFAULT_RULES`` (``:23``),
``FSDP_RULES`` (``:40``), ``SP_RULES`` (``:53``), ``RULE_SETS`` (``:65``),
``spec_for`` (``:76``), ``tree_shardings`` (``:111``), ``batch_spec``
(``:136``) and ``data_axis_names`` (``:145``), with the same rules and the
same divisibility-aware fallback: each logical name takes the first
candidate group of mesh axes that exists in the mesh, divides the
dimension and is not taken by another dimension of the same tensor.

JAX's ``PartitionSpec`` is :class:`PartitionSpec` here, a tuple whose
entries are JAX's entry for entry (``None``, an axis name, or a tuple of
names), trailing ``None`` entries dropped. :class:`NamedSharding` pairs it
with a ``torch.distributed`` ``DeviceMesh`` and gives the DTensor
placements, one per mesh dimension: ``Shard(d)`` where tensor dimension d
takes that mesh axis, ``Replicate()`` otherwise. An entry that spans
several mesh axes (``("pod", "data")``) shards one tensor dimension over
each of them, outer axis first, which is how DTensor orders the blocks of
a dimension sharded over several mesh dimensions and how JAX orders them.

A mesh is anything with axis sizes: a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or an object whose ``shape`` maps axis
names to sizes, as the reference's tests' ``FakeMesh`` does; the rules
never touch a process group. ``with_shardings`` (``:128``) serves only the
reference's AOT ``.lower()`` and has no counterpart yet (ROADMAP.md).
This module imports torch only where it builds placements or moves
tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

# Default rules: TP over "model", DP/FSDP over ("pod","data").
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (),
    "vocab": (("model",),),
    "embed": (),  # replicated by default; FSDP rule overrides
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (("model",),),  # fallback target when kv_heads indivisible
    "mlp": (("model",),),
    "experts": (("model",),),
    "expert_ff": (),
    "rnn": (("model",),),
    "rnn_in": (),
    "frontend": (),
}

FSDP_RULES = dict(DEFAULT_RULES)
# ZeRO-3-style parameter sharding over both data-parallel axes; falls back
# to ("data",) on the single-pod mesh.
FSDP_RULES["embed"] = (("pod", "data"), ("data",))

# Sequence-parallel + ZeRO-3 plan: the model axis shards the sequence of
# the activations (MeshContext.constrain_batch) and stores parameters over
# (data, model); lm_head keeps vocab over model.
SP_RULES = dict(DEFAULT_RULES)
SP_RULES.update({
    "seq": (("model",),),
    "embed": (("data", "model"), ("data",)),
    "vocab": (("model",),),
    "heads": (),
    "kv_heads": (),
    "head_dim": (),
    "mlp": (),
    "rnn": (),
})

RULE_SETS = {"tp": DEFAULT_RULES, "fsdp": FSDP_RULES, "sp_zero3": SP_RULES}


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per leading tensor dimension,
    ``None`` (replicated), a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}``: a ``DeviceMesh``'s named dimensions, or the
    ``shape`` mapping of a mesh stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outer first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axes_in_mesh(shape: Mapping[str, int], cand: Sequence[str]) -> bool:
    return all(a in shape for a in cand)


def _mesh_size(shape: Mapping[str, int], cand: Sequence[str]) -> int:
    return math.prod(shape[a] for a in cand)


def spec_for(
    shape: Sequence[int],
    axes: Sequence[str | None],
    mesh,
    rules: Mapping[str, tuple] = DEFAULT_RULES,
) -> PartitionSpec:
    """The spec of one tensor. Copy of ``repro/distributed/sharding.py:76``.

    Per-tensor exclusivity: once a mesh axis is used by a dim, later dims
    cannot reuse it. ``kv_heads`` and ``head_dim`` cooperate: if kv_heads
    takes "model", head_dim's fallback is skipped."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        placed = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand = tuple(cand)
                if not cand or not _axes_in_mesh(sizes, cand):
                    continue
                if any(a in used for a in cand):
                    continue
                if dim % _mesh_size(sizes, cand) != 0:
                    continue
                placed = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        entries.append(placed)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the counterpart of
    ``jax.sharding.NamedSharding``. ``placements`` are the DTensor
    placements, one per mesh dimension in the mesh's order; a mesh
    dimension of one rank is ``Replicate()`` (it holds the whole tensor
    either way, and DTensor cannot view a dimension of one element that is
    sharded, even over one rank)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        owner: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            axes = entry_axes(entry)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"{self.spec}: the axes {axes} of dimension {d} are not in "
                                 f"the mesh's order {names}")
            owner.update({a: d for a in axes})
        sizes = mesh_shape(self.mesh)
        return tuple(Shard(owner[n]) if n in owner and sizes[n] > 1 else Replicate()
                     for n in names)

    def local_slices(self, shape: Sequence[int]) -> tuple[slice, ...]:
        """The block of a ``shape`` tensor that this rank holds: along each
        sharded dimension, block ``c`` of ``n`` where ``c`` is this rank's
        coordinate over the entry's axes, outer axis major."""
        sizes = mesh_shape(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        out = []
        for d, dim in enumerate(shape):
            axes = entry_axes(self.spec[d]) if d < len(self.spec) else ()
            n, c = 1, 0
            for a in axes:
                n, c = n * sizes[a], c * sizes[a] + coord[a]
            if dim % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not divide over "
                                 f"{axes} ({n} ranks)")
            step = dim // n
            out.append(slice(c * step, (c + 1) * step))
        return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def tree_map_axes(fn: Callable, tree: Any, axes_tree: Any) -> Any:
    """``fn(leaf, axes)`` over a tree of leaves and its matching tree of
    logical axes (dicts, lists and NamedTuples; an axes tuple is a leaf)."""
    if _is_axes(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(axes_tree, Mapping):
        return {k: tree_map_axes(fn, tree[k], a) for k, a in axes_tree.items()}
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(tree_map_axes(fn, getattr(tree, f), getattr(axes_tree, f))
                                 for f in axes_tree._fields))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, t, a) for t, a in zip(tree, axes_tree))
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def tree_shardings(
    shapes_tree: Any,
    axes_tree: Any,
    mesh,
    rules: Mapping[str, tuple] = DEFAULT_RULES,
) -> Any:
    """(tree of shapes or tensors, logical-axes tree) -> tree of
    :class:`NamedSharding`. Copy of ``repro/distributed/sharding.py:111``."""

    def one(leaf, axes):
        return NamedSharding(mesh, spec_for(tuple(leaf.shape) if hasattr(leaf, "shape")
                                            else tuple(leaf), axes, mesh, rules))

    return tree_map_axes(one, shapes_tree, axes_tree)


def batch_spec(mesh, batch_size: int, rank: int = 2) -> PartitionSpec:
    """Spec of a (batch, ...) activation or input. Copy of
    ``repro/distributed/sharding.py:136``."""
    sizes = mesh_shape(mesh)
    for cand in DEFAULT_RULES["batch"]:
        if _axes_in_mesh(sizes, cand) and batch_size % _mesh_size(sizes, cand) == 0:
            first = tuple(cand) if len(cand) > 1 else cand[0]
            return PartitionSpec(first)
    return PartitionSpec()


def data_axis_names(mesh) -> tuple[str, ...]:
    """Copy of ``repro/distributed/sharding.py:145``."""
    sizes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def full_value(x):
    """A DTensor's whole value as a plain tensor on every rank (its
    ``full_tensor``, collective over its mesh); any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def distribute(tensor, sharding: NamedSharding):
    """``tensor`` (the whole value, the same on every rank) as a DTensor
    placed by ``sharding``: each rank keeps its own block of its own copy,
    with no collective (``distribute_tensor(..., src_data_rank=None)``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor, sharding.mesh, sharding.placements, src_data_rank=None)
