"""What a kernel call costs, as the dry run's counter counts it.

Each wrapper on the LM path (``flash_attention``, ``rg_lru``,
``mlstm_chunk`` and their training entries) runs its kernel, its plain
version or, on the meta device, nothing inside ``kernel(name, flops,
nbytes)``. A counter of ``launch/hlo_cost.py`` that is listening adds the
call's FLOPs and bytes under ``name`` (the ``LAUNCHES`` name the card
counts it under) and does not count the operators that run inside: the
plain version's on the CPU, the wrapper's copies and allocations on the
card. So one step counts the same on the meta device, on the CPU and on
the card. ``record`` adds the cost of operators that a meta branch cannot
run (a count read back to the host). Without a listening counter both do
nothing.

The FLOPs are the reference's reckoning (``repro/launch/hlo_cost.py:8-14``):
the dot products of the XLA program the kernel stands for, ``2·M·N·K``
each. The bytes are the call's inputs read once and its outputs written
once.
"""

from __future__ import annotations

import contextlib

import torch

# the counters listening, innermost last (launch/hlo_cost.py adds and removes them)
COUNTERS: list = []


def nbytes(*tensors: torch.Tensor | None) -> int:
    """The bytes of the tensors' elements (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@contextlib.contextmanager
def kernel(name: str, flops: float, moved: int):
    """One call of kernel ``name`` that does ``flops`` and moves ``moved``
    bytes; the operators run inside are not counted."""
    for c in COUNTERS:
        c.kernel_enter(name, flops, moved)
    try:
        yield
    finally:
        for c in reversed(COUNTERS):
            c.kernel_exit()


def record(flops: float = 0.0, moved: int = 0) -> None:
    """Operators a meta branch stands in for: ``flops`` and ``moved`` bytes."""
    for c in COUNTERS:
        c.add(flops, moved)


def contiguous(tensors):
    """A plain version's outputs in the kernel's layout (each contiguous,
    None kept), so that the operators after a call are the same on the
    CPU as on the card."""
    return tuple(None if t is None else t.contiguous() for t in tensors)
