#!/usr/bin/env python3
"""The bytes each rank receives in one decode step to give the serving
kernels whole heads, on the production meshes, worked out from the shapes.

    PYTHONPATH=src python3 tools/mesh_decode_gather.py [--multi-pod]

For every causal configuration's ``decode_32k`` and ``long_500k`` cell
(``configs.all_cells``) the state of ``LM.init_decode_state`` in bf16 (as
the dry run builds it; on the meta device, nothing allocated) is placed by
``decode_state_axes()`` under ``DEFAULT_RULES`` on the ``(16, 16)`` mesh of
``(data, model)`` (``--multi-pod``: ``(2, 16, 16)`` with ``pod``). A kernel
reads a KV cache at its rows and kv heads and the mLSTM state at its rows
and heads (``models/attention.py cache_placements``,
``models/xlstm.py mlstm_scan``); a leaf that the rules shard over another
dimension (``head_dim`` where the kv heads do not divide the model axis,
``rnn`` where the mLSTM heads do not) is gathered over those mesh axes for
every step. A rank receives ``(g - 1) / g`` of the gathered block, ``g``
the ranks of the axes gathered over. A KV cache is gathered only up to
the positions the step reads (``kv_len``): the counts are those of a step
at the cell's last position, where that is the whole cache, the most a
step moves; a step at position P moves ``(P + 1) / seq_len`` of the
cache's share. Prints one line a cell with a gather: the leaves' kinds,
the bytes a rank holds of the state, the bytes it receives at the last
step, and their ratio; and, for a gathered KV cache, what a ring
all-reduce of partial fp32 scores ``(rows, heads, 1, keys)`` over the
same ranks would move instead (``2 (g - 1) / g`` of them a layer): the
traffic of an attention over each rank's ``head_dim`` slice, which is
what the reference's decode does (``repro/models/attention.py:250``, an
einsum over ``head_dim`` that GSPMD partitions into partial scores and an
all-reduce). Counts, no device metric."""

from __future__ import annotations

import argparse
import math
from types import SimpleNamespace

import torch

from repro_torch.configs import SHAPES, all_cells, get
from repro_torch.distributed.sharding import DEFAULT_RULES, entry_axes, spec_for
from repro_torch.models.lm import LM


def blocks(leaf: torch.Tensor, axes: tuple, sizes: dict) -> list[int]:
    """The ranks each dimension of ``leaf`` is split over by the rules."""
    spec = spec_for(tuple(leaf.shape), axes, SimpleNamespace(shape=sizes), DEFAULT_RULES)
    return [math.prod(sizes[a] for a in entry_axes(spec[d])) if d < len(spec) else 1
            for d in range(leaf.ndim)]


def gather_bytes(leaf: torch.Tensor, split: list[int], kept: tuple[int, ...]
                 ) -> tuple[int, int]:
    """(bytes a rank holds of ``leaf``, bytes it receives to read it with
    only the dimensions ``kept`` split)."""
    size = leaf.numel() * leaf.element_size()
    gathered = math.prod(n for d, n in enumerate(split) if d not in kept)
    block = size // math.prod(n for d, n in enumerate(split) if d in kept)
    return size // math.prod(split), block * (gathered - 1) // gathered


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    sizes = {"pod": 2, "data": 16, "model": 16} if args.multi_pod else {"data": 16, "model": 16}
    for arch, shape_name in all_cells():
        shape = SHAPES[shape_name]
        cfg = get(arch)
        if shape.kind != "decode" or not cfg.causal:
            continue
        model = LM(cfg, "meta", dtype=torch.bfloat16)
        state = model.init_decode_state(shape.global_batch, shape.seq_len)
        held = received = scores = 0
        kinds = set()
        for kind, leaves, axes in zip(model.kinds, state, model.decode_state_axes()):
            if kind not in ("attn", "mlstm"):
                continue
            kept = (0, 2) if kind == "attn" else (0, 1)  # rows, and kv heads or heads
            for leaf, leaf_axes in zip(leaves, axes):
                split = blocks(leaf, leaf_axes, sizes)
                h, r = gather_bytes(leaf, split, kept)
                held += h
                received += r
                if r:
                    kinds.add(kind)
                if kind == "attn" and r and leaf is leaves.k:  # v is placed as k
                    g = math.prod(n for d, n in enumerate(split) if d not in kept)
                    rows = leaf.shape[0] // split[0]
                    scores += rows * cfg.n_heads * leaf.shape[1] * 4 * 2 * (g - 1) // g
        if received:
            alt = f"; partial scores would move {scores:,} B" if scores else ""
            print(f"{arch} {shape_name}: gathers {'/'.join(sorted(kinds))} state; a rank holds "
                  f"{held:,} B of it and receives {received:,} B at the last step "
                  f"({received / held:.2f}x){alt}")


if __name__ == "__main__":
    main()
