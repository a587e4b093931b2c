"""The dry run's cost model: FLOPs, bytes, collectives and memory of one
eager run, counted operator by operator.

Counterpart of ``repro/launch/hlo_cost.py``, which parses a compiled XLA
module and multiplies each while loop's body by its trip count. The port
has no HLO. ``analyze(fn, *args)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts the aten operators it dispatches, which
sit below autograd, so a backward's operators are counted too. An eager
loop runs every trip, so ``unresolved_whiles`` is always 0. On the meta
device nothing is computed and nothing is allocated, so a step at a size
no card holds is counted in seconds.

* ``flops``: only the matmul-class operators (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``linear``, ``matmul`` and ``einsum`` reach them as they
  decompose), ``2·M·N·K`` each by ``torch.utils.flop_counter``'s
  formulas, as the reference counts only ``dot``.
* ``bytes``: the op-aware rule of ``repro/launch/hlo_cost.py:151-167``:
  a copying slice or gather (``index``, ``index_select``, ``gather``,
  ``embedding``) counts 2 × its result; an update into a region
  (``index_put``, ``index_copy``, ``index_add``, ``scatter``, ``copy_``)
  2 × the update; a fill or ``arange`` its result; an operator that only
  makes a view (a slice of the port is one), only allocates (``empty``)
  or copies between the host and a device counts 0; every other operator
  its operands plus its result.
* ``kernels``: a hand-written kernel's wrapper runs inside
  ``kernels/cost.kernel``, whose recorded cost stands for the call; the
  operators run inside it (the plain version's on the CPU, the wrapper's
  copies on the card, nothing on meta) are not counted. So one step
  counts the same on meta, on the CPU and on the card. Each kernel's
  calls, FLOPs and bytes are also reported under its ``LAUNCHES`` name.
* host operators: in a run on the card or on meta, an operator whose
  tensors all lie on the host is the host's bookkeeping (the copy of the
  card's RNG state that ``torch.utils.checkpoint`` makes) and is not
  counted; the run's device is its first argument's.
* ``collective_*``: the functional collectives (``_c10d_functional``'s
  ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``) under the reference's rule (``:250-258``): the
  result's bytes, twice for an all-reduce, also added to ``bytes`` once.
* ``memory``: the bytes of the arguments' storages, of the result's, and
  ``temp``, the peak of the bytes that storages made during the run hold
  at once, followed through ``StorageWeakRef``. Released storages are
  swept out whenever the bytes held may have passed the peak by 1%, so
  ``temp`` is the true peak or at most 1% below it.
"""

from __future__ import annotations

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import cost

aten = torch.ops.aten

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
_COLLECTIVES = {"_c10d_functional::all_reduce": "all-reduce",
                "_c10d_functional::all_gather_into_tensor": "all-gather",
                "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
                "_c10d_functional::all_to_all_single": "all-to-all"}
MATMUL_OPS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
GATHER_OPS = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take}
# the update's position among the arguments
UPDATE_OPS = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
              aten.index_copy: 3, aten.index_copy_: 3, aten.index_add: 3, aten.index_add_: 3,
              aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
              aten.copy_: 1}
FILL_OPS = {aten.fill, aten.fill_, aten.zero_, aten.zeros, aten.ones, aten.full,
            aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros, aten.new_ones,
            aten.new_full, aten.scalar_tensor, aten.arange, aten.linspace}
TRANSFER_OPS = {aten._to_copy, aten.copy_}
NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh}
_FRESH: dict = {}  # operator -> whether its outputs are new storages


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storages(tree) -> dict:
    """{StorageWeakRef: bytes} of the tensors' distinct storages."""
    return {StorageWeakRef(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one operator moves, by the rule above."""
    packet = func.overloadpacket
    if func.is_view or packet in NO_BYTES:
        return 0
    result = _bytes(_tensors(out))
    if packet in TRANSFER_OPS and len({t.device for t in _tensors((args, out))}) > 1:
        return 0  # between the host and a device: not the device's memory traffic
    if packet in GATHER_OPS:
        return 2 * result
    if packet in UPDATE_OPS:
        i = UPDATE_OPS[packet]
        update = args[i] if len(args) > i else None
        if isinstance(update, torch.Tensor):
            return 2 * _bytes([update])
        index = args[2]  # scatter of a scalar: one element an index
        return 2 * index.numel() * _tensors(out)[0].element_size()
    if packet in FILL_OPS:
        return result
    return result + _bytes(_tensors((args, kwargs)))


class CostCounter(TorchDispatchMode):
    """Counts what the operators dispatched while it is active cost; see
    the module's docstring. ``exclude`` names the tree of tensors whose
    storages existed before (the arguments): they are never taken for
    storages the run made, and the first of them names the run's device."""

    def __init__(self, exclude=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.coll = {k: 0.0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.kernels: dict[str, dict] = {}
        self._depth = 0  # open kernel scopes
        self._before = _storages(exclude)
        tensors = _tensors(exclude)  # the run's device: its first argument's
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self._live: dict = {}  # StorageWeakRef -> bytes, storages the run made
        self._current = 0  # bytes of _live, released ones included until a sweep
        self.peak = 0

    def __enter__(self):
        cost.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost.COUNTERS.remove(self)
        return super().__exit__(*exc)

    # -- the kernel scopes of kernels/cost.py ---------------------------------
    def kernel_enter(self, name: str, flops: float, moved: int) -> None:
        if self._depth == 0:
            self.add(flops, moved)
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += moved
        self._depth += 1

    def kernel_exit(self) -> None:
        self._depth -= 1

    def add(self, flops: float, moved: int) -> None:
        if self._depth == 0:
            self.flops += flops
            self.bytes += moved

    def merge(self, rec: dict) -> None:
        """Add another count (a ``result()``), as if its operators ran here."""
        if self._depth:
            return
        self.flops += rec["flops"]
        self.bytes += rec["bytes"]
        self.n_ops += rec["n_ops"]
        for kind in COLLECTIVE_OPS:
            self.coll[kind] += rec["collective_bytes"][kind]
            self.coll_counts[kind] += rec["collective_counts"][kind]
        for name, k in rec["kernels"].items():
            mine = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            for key in mine:
                mine[key] += k[key]

    # -- operators ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0:
            self._count(func, args, kwargs, out)
        fresh = _FRESH.get(func)
        if fresh is None:  # outputs that alias no input: storages the op made
            fresh = _FRESH[func] = not func.is_view and not any(
                r.alias_info for r in func._schema.returns)
        if fresh:
            self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if self.device.type != "cpu" and all(
                t.device.type == "cpu" for t in _tensors((args, kwargs, out))):
            return  # host bookkeeping of a device run (checkpoint's copy of the RNG state)
        self.n_ops += 1
        name = func._schema.name
        if name == "_c10d_functional::wait_tensor":
            return
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            result = _bytes(_tensors(out))
            self.coll[kind] += 2 * result if kind == "all-reduce" else result
            self.coll_counts[kind] += 1
            self.bytes += result
            return
        if func.overloadpacket in MATMUL_OPS:
            self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        self.bytes += op_bytes(func, args, kwargs, out)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref in self._before or ref in self._live:
                continue
            self._live[ref] = st.nbytes()
            self._current += self._live[ref]
            if self._current > self.peak + self.peak // 100:
                self._sweep()
                self.peak = max(self.peak, self._current)

    def _sweep(self) -> None:
        for ref in [r for r in self._live if r.expired()]:
            self._current -= self._live.pop(ref)

    def live_bytes(self) -> int:
        """The bytes the storages made during the run still hold."""
        self._sweep()
        return self._current

    def result(self) -> dict:
        """The reference's keys (``n_ops`` in place of ``n_computations``),
        ``kernels`` and ``temp_bytes``."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": dict(self.coll),
            "collective_counts": dict(self.coll_counts),
            "collective_total": sum(self.coll.values()),
            "unresolved_whiles": 0,
            "n_ops": self.n_ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "temp_bytes": self.peak,
        }


def replay(rec: dict) -> None:
    """Add ``rec`` to every counter listening, for a call whose count is
    known and that is not run again (the dry run's later microbatches)."""
    for counter in cost.COUNTERS:
        counter.merge(rec)


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a ``CostCounter`` -> its
    ``result()`` and ``memory`` {``argument``: the arguments' storages,
    ``output``: the result's, ``temp``: the run's peak}, in bytes."""
    with CostCounter(exclude=(args, kwargs)) as counter:
        out = fn(*args, **kwargs)
    rec = counter.result()
    rec["memory"] = {"argument": sum(_storages((args, kwargs)).values()),
                     "output": sum(_storages(out).values()), "temp": counter.peak}
    return rec
