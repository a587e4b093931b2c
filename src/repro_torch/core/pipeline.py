"""Spark-ML-style ``Pipeline``: chained transformer stages over a frame.

Copy of ``repro/core/pipeline.py``: ``Pipeline`` (``:51``),
``_split_on_rows`` (``:59``), ``_run_ops`` (``:71``),
``compile_column_plans`` (``:80``), ``run_column_plans`` (``:111``),
``PipelineModel`` (``:142``) and ``default_workers`` (``:161``), with the
device of the ``device`` backend passed through.

Algorithm 1, steps 11-14: the stages are declared (step 11),
``Pipeline.fit`` gives a ``PipelineModel`` (step 13; every stage is a pure
transformer), and ``PipelineModel.transform`` runs them (step 14). Per
column, the frame is flattened once into a byte buffer, the column's op
chain runs over it (``bytesops.execute_ops``), and the result is
unflattened once. ``optimize=True`` fuses each column's ops across stage
boundaries first (``bytesops.fuse_ops``); both give the same bytes.

With ``workers > 1`` each column's buffer is split at row boundaries over
a process pool. The pool's workers are spawned, not forked as the
reference's: the caller may hold a CUDA context and threads. Their task
imports this module, numpy and the frame, never torch. The ``device``
backend refuses ``workers > 1``: the reference's forked children quietly
take the host scan (``repro/core/bytesops.py:905-906``), and the port does
not hide the card.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

import numpy as np

from . import bytesops as B
from .engine_config import EngineConfig
from .frame import ColumnarFrame
from .stages import Stage

# One compiled per-column unit: read input_col, run ops, write output_col.
ColumnPlan = tuple[str, str, list[B.Op]]


class Pipeline:
    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    def fit(self, frame: ColumnarFrame) -> "PipelineModel":
        return PipelineModel([s.fit(frame) for s in self.stages])


def _split_on_rows(buf: np.ndarray, k: int) -> list[np.ndarray]:
    """Split a flat buffer into at most k chunks at row-separator boundaries."""
    if k <= 1 or buf.size == 0:
        return [buf]
    sep_idx = np.flatnonzero(buf == B.ROW_SEP)
    if sep_idx.size < k:
        return [buf]
    cut_rows = np.linspace(0, sep_idx.size, k + 1).astype(np.int64)[1:-1]
    cuts = sep_idx[cut_rows - 1] + 1
    return np.split(buf, cuts)


def _run_ops(args) -> np.ndarray:
    """Pool task: ``(ops, buf, backend)``, a host backend resolved in the
    calling process before fan-out."""
    ops, buf, backend = args
    return B.execute_ops(buf, ops, backend)


def check_workers(backend: str, workers: int) -> None:
    """``ValueError`` for the ``device`` backend over a process pool."""
    if backend == "device" and workers > 1:
        raise ValueError(
            f"the device backend runs in one process (workers={workers}); its "
            "scan passes go to the card from the caller. Use workers=1, or a "
            "host backend ('loops' or 'fused') with workers > 1"
        )


def compile_column_plans(stages: Sequence[Stage], optimize: bool) -> list[ColumnPlan]:
    """Ordered (input_col, output_col, ops) plans for a stage chain.

    Consecutive stages on one column merge into one plan; a stage with
    ``output_col != input_col`` forks a new plan fed by the current state
    of its input column.
    """
    plans: list[ColumnPlan] = []
    current: dict[str, int] = {}  # column -> index of its live plan
    for s in stages:
        ops = s.flat_ops()
        if s.input_col not in current:
            plans.append((s.input_col, s.input_col, []))
            current[s.input_col] = len(plans) - 1
        if s.output_col == s.input_col:
            plans[current[s.input_col]][2].extend(ops)
        else:
            src_plan = current[s.input_col]
            plans.append((plans[src_plan][1], s.output_col, list(ops)))
            current[s.output_col] = len(plans) - 1
            # Seal the source plan: later stages on input_col must not change
            # what this fork read (Spark's order); they start a fresh plan.
            current.pop(s.input_col, None)
    if optimize:
        plans = [(i, o, B.fuse_ops(ops)) for i, o, ops in plans]
    return plans


def run_column_plans(
    frame: ColumnarFrame,
    plans: Sequence[ColumnPlan],
    workers: int = 1,
    backend: str | None = None,
    device=None,
) -> ColumnarFrame:
    """Flatten each input column once, run its op chain (over a spawned
    process pool when ``workers > 1``), unflatten once."""
    backend = EngineConfig(backend=backend).resolve_backend()
    check_workers(backend, workers)
    bufs: dict[str, np.ndarray] = {}
    out = frame
    pool = None
    if workers > 1:
        pool = ProcessPoolExecutor(max_workers=workers,
                                   mp_context=multiprocessing.get_context("spawn"))
    try:
        for in_col, out_col, ops in plans:
            src = bufs.get(in_col)
            if src is None:
                src = frame.flat(in_col)
            if pool is None:
                res = B.execute_ops(src, ops, backend, device)
            else:
                chunks = _split_on_rows(src, workers)
                parts = list(pool.map(_run_ops, [(ops, c, backend) for c in chunks]))
                res = np.concatenate(parts) if parts else src
            bufs[out_col] = res
            out = out.ensure_column(out_col).with_flat(out_col, res)
    finally:
        if pool is not None:
            pool.shutdown()
    return out


class PipelineModel:
    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)

    def column_plans(self, optimize: bool) -> list[ColumnPlan]:
        return compile_column_plans(self.stages, optimize)

    def transform(
        self,
        frame: ColumnarFrame,
        workers: int = 1,
        optimize: bool = True,
        backend: str | None = None,
        device=None,
    ) -> ColumnarFrame:
        return run_column_plans(frame, self.column_plans(optimize), workers,
                                backend=backend, device=device)


def default_workers() -> int:
    return max(1, os.cpu_count() or 1)
