"""Device meshes over a ``torch.distributed`` process group.

Counterpart of ``repro/launch/mesh.py``. A mesh is a ``DeviceMesh`` with
named dimensions, ``("data", "model")`` or ``("pod", "data", "model")``,
over the default process group: one rank per device. Its functions only
build meshes when called; importing this module touches no process group.

* ``make_host_mesh`` (``:58``) and ``make_production_mesh`` (``:49``)
  build the mesh over the process group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...), or over a group of one
  rank on a ``FileStore`` in a temporary directory when none is described.
  The production mesh needs 256 or 512 ranks and says how many it found,
  as JAX fails for lack of devices.
* ``shard_map`` (``:25``) is ``torch.distributed.tensor.experimental.
  local_map``: the function sees each rank's local tensors.
* ``set_mesh`` (``:39``) is a context manager with no effect on placement:
  a DTensor carries its mesh, so there is no ambient mesh to install.
* ``_axis_kwargs`` and the ``AxisType`` shim (``:11-22``) bridge JAX
  versions and have no counterpart.

``kernel_call`` is the port's own: it runs a hand-written kernel's wrapper
on the local shards of its DTensor arguments, so that the wrapper sees
plain tensors, keeps its dispatch (the CUDA kernel on a card tensor, the
plain version on a CPU tensor) and counts its launches.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_process_group(device_type: str) -> None:
    """Join the default process group once: the one ``torchrun``'s
    variables describe, else a group of one rank over a ``FileStore`` in a
    temporary directory. ``nccl`` on the card, ``gloo`` on the CPU. On the
    card each rank takes card ``LOCAL_RANK`` and raises when it sees none."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda': no CUDA card is visible to this rank")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} but {torch.cuda.device_count()} visible "
                               "card(s)")
        torch.cuda.set_device(local)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(_backend(device_type))
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store"), 1)
    dist.init_process_group(_backend(device_type), store=store, rank=0, world_size=1)


def destroy_process_group() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _device_type(device) -> str:
    if device is None:
        return "cuda"
    return torch.device(device).type


def make_host_mesh(model_parallel: int = 1, device=None):
    """``(world // model_parallel, model_parallel)`` over ``("data",
    "model")``, on the card unless ``device`` names another type."""
    kind = _device_type(device)
    init_process_group(kind)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide the world of "
                         f"{n} rank(s)")
    return _mesh(kind, (n // model_parallel, model_parallel), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16 × 16 = 256 ranks ``(data, model)``. Multi-pod: 2 pods
    of 256 = 512 ranks ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind = _device_type(device)
    init_process_group(kind)
    need, n = 512 if multi_pod else 256, dist.get_world_size()
    if n != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; the world has {n}")
    return _mesh(kind, shape, axes)


def shard_map(fn: Callable, *, mesh, in_specs, out_specs, in_grad_specs=None,
              redistribute_inputs: bool = False) -> Callable:
    """``fn`` on each rank's local tensors: ``local_map`` with DTensor
    placements (one sequence per argument, None for a non-tensor) in place
    of JAX's specs."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_specs, in_placements=in_specs,
                     in_grad_placements=in_grad_specs, device_mesh=mesh,
                     redistribute_inputs=redistribute_inputs)


def set_mesh(mesh):
    """A context manager that installs nothing: DTensors carry their mesh."""
    del mesh
    return contextlib.nullcontext()


@contextlib.contextmanager
def replicate_plain():
    """A scope in which DTensor operators take a plain tensor (a position
    table, a constant, one the forward saved for the backward) as a
    replicated value. Unlike ``implicit_replication``, which turns the
    switch off on leaving, it restores what the switch was, so that scopes
    nest (a checkpointed layer's recompute inside the backward's scope)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def kernel_call(fn: Callable, args: Sequence, placements: Sequence, out_placements,
                in_grad: Sequence | None = None, **kwargs):
    """``fn(*args, **kwargs)`` on the local shards: each DTensor argument
    is first redistributed to its entry of ``placements`` (a no-op where
    it already lies so), a plain tensor (the whole value on every rank,
    e.g. a fresh state) is cut to this rank's block, None passes through,
    and the outputs are DTensors placed by ``out_placements`` (a sequence
    of placements, or a tuple of them for several outputs). ``in_grad``
    gives the placements of the inputs' gradients where they differ from
    ``placements`` (a weight replicated over the data axes gets a partial
    sum there)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    moved = [None if a is None
             else a.redistribute(mesh, p) if is_dtensor(a)
             else distribute_tensor(a, mesh, p, src_data_rank=None)
             for a, p in zip(args, placements)]
    in_specs = tuple(None if a is None else p for a, p in zip(moved, placements))
    grads = None if in_grad is None else tuple(
        None if a is None else g for a, g in zip(moved, in_grad))
    return shard_map(lambda *xs: fn(*xs, **kwargs), mesh=mesh, in_specs=in_specs,
                     out_specs=out_placements, in_grad_specs=grads)(*moved)
