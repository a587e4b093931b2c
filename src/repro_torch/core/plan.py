"""Logical plan and planner behind the lazy ``Dataset`` API.

Copy of ``repro/core/plan.py`` (the whole file):

* **Logical plan**: a linear sequence of immutable nodes
  (``SourceJsonDirs -> Select/DropNA/DropDuplicates/Project/Filter/Split ->
  Tokenize -> Batch -> Prefetch``) built by
  :class:`repro_torch.core.dataset.Dataset`; ``Project`` carries
  ``(out_col, expression)`` entries and ``Filter`` a row predicate of
  :mod:`repro_torch.core.expr`.
* **Optimizer** (:func:`optimize_plan`): the reference's exact rewrites:
  adjacent ``Project``/``DropNA``/``Filter`` nodes merge, row filters
  commute backward past a ``Project`` that writes nothing they read
  (splitting conjunctions and ``DropNA`` subsets at it), dead derived
  columns are pruned, the source is narrowed to the live columns, and
  shared sub-expressions hoist into ``__cse_*`` intermediates
  (:func:`_cse_pass`). :func:`explain` prints the logical and optimized
  plans as the reference does.
* **Physical executors**: :func:`execute_frame_plan` runs the frame-level
  prefix whole-frame with the paper's stage timings
  (:class:`StageTimings`, whose home this is; ``core.p3sapp`` re-exports
  it); :func:`stream_batches` runs the same plan per shard over the thread
  shard executor with the optional shard cache
  (:mod:`repro_torch.core.executor`).
* **Fingerprints**: :func:`plan_fingerprint` hashes the optimized plan,
  port-tagged.

Where the port differs: the executors take the ``device`` on which the
``device`` backend's scan passes run (the card unless the caller names
another), ``run_project_frame`` fans row chunks out over spawned processes
only under a host backend (``pipeline.check_workers`` refuses the
``device`` backend with ``workers > 1``), and :func:`explain`'s physical
line names the port's default backend, ``device``, when the plan names
none.
"""

from __future__ import annotations

import hashlib
import heapq
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

from ..data.batching import (
    TokenSpec,
    emit_bucketed,
    encode_frame_columns,
    pad_batch,
    split_indices,
)
from . import bytesops as B
from . import expr as E
from . import ingest as ing
from .frame import ColumnarFrame


@dataclass
class StageTimings:
    """Paper §3 timing attribution (eq. 7), extended with the token step:
    ``tokenize`` covers text->int32 encoding and vocabulary counting. Copy of
    ``repro/core/plan.py:62``."""

    ingestion: float = 0.0
    pre_cleaning: float = 0.0
    cleaning: float = 0.0
    post_cleaning: float = 0.0
    tokenize: float = 0.0

    @property
    def preprocessing(self) -> float:
        return self.pre_cleaning + self.cleaning + self.post_cleaning + self.tokenize

    @property
    def cumulative(self) -> float:
        return self.ingestion + self.preprocessing

    def as_dict(self) -> dict:
        return {
            "ingestion": self.ingestion,
            "pre_cleaning": self.pre_cleaning,
            "cleaning": self.cleaning,
            "post_cleaning": self.post_cleaning,
            "tokenize": self.tokenize,
            "preprocessing": self.preprocessing,
            "cumulative": self.cumulative,
        }


# ---------------------------------------------------------------------------
# Logical plan nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanNode:
    """Copy of ``repro/core/plan.py:99``."""
    def describe(self) -> str:
        return type(self).__name__


@dataclass(frozen=True)
class SourceJsonDirs(PlanNode):
    """Copy of ``repro/core/plan.py:105``."""
    directories: tuple[str, ...]
    fields: tuple[str, ...]

    def describe(self) -> str:
        return f"SourceJsonDirs(dirs={len(self.directories)}, fields={list(self.fields)})"


@dataclass(frozen=True)
class SourceFrame(PlanNode):
    """Copy of ``repro/core/plan.py:114``."""
    frame: Any  # ColumnarFrame

    def describe(self) -> str:
        return f"SourceFrame(rows={len(self.frame)}, fields={self.frame.field_names})"


@dataclass(frozen=True)
class Select(PlanNode):
    """Copy of ``repro/core/plan.py:122``."""
    fields: tuple[str, ...]

    def describe(self) -> str:
        return f"Select({list(self.fields)})"


@dataclass(frozen=True)
class DropNA(PlanNode):
    """Copy of ``repro/core/plan.py:130``."""
    subset: tuple[str, ...]

    def describe(self) -> str:
        return f"DropNA({list(self.subset)})"


@dataclass(frozen=True)
class DropDuplicates(PlanNode):
    """Copy of ``repro/core/plan.py:138``."""
    subset: tuple[str, ...]

    def describe(self) -> str:
        return f"DropDuplicates({list(self.subset)})"


@dataclass(frozen=True, eq=False)
class Project(PlanNode):
    """Sequential ``(out_col, expression)`` entries — entry k sees the
    columns entries < k wrote (Spark ``withColumn`` chaining). Copy of
    ``repro/core/plan.py:146``."""

    exprs: tuple[tuple[str, E.Expr], ...]

    def written(self) -> set[str]:
        return {out for out, _ in self.exprs}

    def describe(self) -> str:
        inner = ", ".join(f"{out}={e.describe()}" for out, e in self.exprs)
        return f"Project({inner})"


@dataclass(frozen=True, eq=False)
class Filter(PlanNode):
    """Row filter by a byte-buffer predicate (``Dataset.where``).
    Copy of ``repro/core/plan.py:161``."""

    pred: E.Pred

    def describe(self) -> str:
        return f"Filter({self.pred.describe()})"


@dataclass(frozen=True)
class Split(PlanNode):
    """Deterministic row split (train/val); ``part`` selects the side.
    Copy of ``repro/core/plan.py:171``."""

    fraction: float
    seed: int
    part: str  # "train" | "val"

    def describe(self) -> str:
        return f"Split({self.part}, fraction={self.fraction}, seed={self.seed})"


@dataclass(frozen=True)
class Tokenize(PlanNode):
    """Copy of ``repro/core/plan.py:183``."""
    tokenizer: Any  # WordTokenizer
    specs: tuple[TokenSpec, ...]

    def describe(self) -> str:
        parts = [
            f"{s.column}->{s.name}[max_len={s.max_len}"
            + (", start_end" if s.add_start_end else "")
            + "]"
            for s in self.specs
        ]
        return f"Tokenize({', '.join(parts)})"


@dataclass(frozen=True)
class Batch(PlanNode):
    """Copy of ``repro/core/plan.py:198``."""
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    pad_to: int | None = None
    # Length-bucketed assembly: rows grouped by the payload length of the
    # ``bucket_by`` token column(s) into the fixed ``buckets`` widths —
    # one width list for a single column, one list per column (a 2-D
    # grid) for paired encoder/decoder bucketing.
    bucket_by: str | tuple[str, ...] | None = None
    buckets: tuple = ()

    def describe(self) -> str:
        base = (
            f"Batch(size={self.batch_size}, shuffle={self.shuffle}, "
            f"seed={self.seed}, drop_remainder={self.drop_remainder}, "
            f"pad_to={self.pad_to}"
        )
        if self.bucket_by is not None:
            bb = (
                self.bucket_by
                if isinstance(self.bucket_by, str)
                else list(self.bucket_by)
            )
            bk = [
                list(b) if isinstance(b, tuple) else b for b in self.buckets
            ]
            base += f", bucket_by={bb}, buckets={bk}"
        return base + ")"


@dataclass(frozen=True)
class Prefetch(PlanNode):
    """Copy of ``repro/core/plan.py:231``."""
    prefetch: int = 2
    sharding: Any = None

    def describe(self) -> str:
        return f"Prefetch(depth={self.prefetch}, sharding={self.sharding is not None})"


FRAME_NODES = (
    SourceJsonDirs, SourceFrame, Select, DropNA, DropDuplicates, Project, Filter, Split
)
ARRAY_NODES = (Tokenize, Batch, Prefetch)


def is_frame_node(node: PlanNode) -> bool:
    """Copy of ``repro/core/plan.py:245``."""
    return isinstance(node, FRAME_NODES)


def split_plan(nodes: Sequence[PlanNode]) -> tuple[list[PlanNode], list[PlanNode]]:
    """(frame-level prefix, array-level suffix). Copy of ``repro/core/plan.py:249``."""
    frame_nodes = [n for n in nodes if is_frame_node(n)]
    array_nodes = [n for n in nodes if not is_frame_node(n)]
    return frame_nodes, array_nodes


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _filter_read_cols(node: PlanNode) -> set[str]:
    """Copy of ``repro/core/plan.py:261``."""
    if isinstance(node, DropNA):
        return set(node.subset)
    assert isinstance(node, Filter)
    return node.pred.inputs()


def _merge_adjacent(nodes: list[PlanNode]) -> list[PlanNode]:
    """Copy of ``repro/core/plan.py:268``."""
    out: list[PlanNode] = []
    for node in nodes:
        prev = out[-1] if out else None
        if isinstance(node, Project) and isinstance(prev, Project):
            out[-1] = Project(prev.exprs + node.exprs)
        elif isinstance(node, DropNA) and isinstance(prev, DropNA):
            merged = prev.subset + tuple(f for f in node.subset if f not in prev.subset)
            out[-1] = DropNA(merged)
        elif isinstance(node, Filter) and isinstance(prev, Filter):
            out[-1] = Filter(prev.pred & node.pred)
        elif isinstance(node, Select) and isinstance(prev, Select):
            out[-1] = node  # the later projection wins
        else:
            out.append(node)
    return out


def _split_row_filter(a: Project, b: PlanNode) -> list[PlanNode] | None:
    """Conjunct-split pushdown: a blocked conjunction filter splits at a
    ``Project`` — conjuncts reading only columns the Project does not
    write commute below it, conjuncts on derived columns stay put. Rows a
    raw-column conjunct rejects are then never cleaned even when the same
    ``where`` also constrains a derived column. ``None`` when no split
    applies (single conjunct, or nothing/everything pushable). Copy of
    ``repro/core/plan.py:286``."""
    written = a.written()
    if isinstance(b, DropNA):
        push = tuple(c for c in b.subset if c not in written)
        stay = tuple(c for c in b.subset if c in written)
        if push and stay:
            return [DropNA(push), a, DropNA(stay)]
        return None
    assert isinstance(b, Filter)
    conjuncts = E.split_conjuncts(b.pred)
    if len(conjuncts) < 2:
        return None
    push = [c for c in conjuncts if not (c.inputs() & written)]
    stay = [c for c in conjuncts if c.inputs() & written]
    if push and stay:
        return [Filter(E.and_all(push)), a, Filter(E.and_all(stay))]
    return None


def _pull_filters_back(nodes: list[PlanNode]) -> list[PlanNode]:
    """A row filter (``DropNA`` or ``Filter``) commutes backward past a
    ``Project`` that does not write any column the filter reads — dropped
    rows are then never flattened/cleaned. This generalizes the original
    dropna pullback to arbitrary ``where`` predicates. A filter that
    cannot move as a unit splits at the conjunction: its raw-column
    conjuncts keep commuting toward the source while the derived-column
    conjuncts stay behind the Project (see :func:`_split_row_filter`). Copy of
    ``repro/core/plan.py:311``."""
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(nodes) - 1:
            a, b = nodes[i], nodes[i + 1]
            if isinstance(a, Project) and isinstance(b, (DropNA, Filter)):
                if not (_filter_read_cols(b) & a.written()):
                    nodes[i], nodes[i + 1] = b, a
                    changed = True
                else:
                    split = _split_row_filter(a, b)
                    if split is not None:
                        nodes[i : i + 2] = split
                        changed = True
            i += 1
        nodes = _merge_adjacent(nodes)
    return nodes


def _node_read_written(node: PlanNode) -> tuple[set[str], set[str]]:
    """(columns the node reads, columns it writes) — liveness bookkeeping.
    Copy of ``repro/core/plan.py:339``."""
    if isinstance(node, (DropNA, DropDuplicates)):
        return set(node.subset), set()
    if isinstance(node, Filter):
        return node.pred.inputs(), set()
    return set(), set()


def _prune_and_project(
    nodes: list[PlanNode], final_schema: Sequence[str]
) -> list[PlanNode]:
    """Backward liveness pass: drop ``Project`` entries whose output nothing
    downstream reads (unused derived columns), then narrow the JSON source
    to the columns actually consumed. Entry pruning needs to know the
    terminal's schema; with an empty ``final_schema`` only the source
    narrowing runs (conservative). Copy of
    ``repro/core/plan.py:348``."""
    prune = bool(final_schema)
    needed = set(final_schema)
    out_rev: list[PlanNode] = []
    for node in reversed(nodes[1:]):
        if isinstance(node, Select):
            needed = set(node.fields)
        elif isinstance(node, Tokenize):
            needed = {spec.column for spec in node.specs}
        elif isinstance(node, Project):
            kept: list[tuple[str, E.Expr]] = []
            for out_col, e in reversed(node.exprs):
                reads = e.inputs()
                if prune and out_col not in needed:
                    continue  # dead derived column: never computed
                if out_col not in reads:
                    needed.discard(out_col)
                needed |= reads
                kept.append((out_col, e))
            if not kept:
                continue  # entire node was dead
            node = Project(tuple(reversed(kept)))
        else:
            reads, _ = _node_read_written(node)
            needed |= reads
        out_rev.append(node)
    nodes = [nodes[0]] + list(reversed(out_rev))
    src = nodes[0]
    if isinstance(src, SourceJsonDirs):
        kept_fields = tuple(f for f in src.fields if f in needed)
        if kept_fields and kept_fields != src.fields:
            nodes[0] = SourceJsonDirs(src.directories, kept_fields)
    return nodes


_CSE_PREFIX = "__cse_"


def _cse_name(sig: bytes) -> str:
    """Copy of ``repro/core/plan.py:393``."""
    return _CSE_PREFIX + hashlib.blake2b(sig, digest_size=16).hexdigest()[:12]


def _cse_pass(nodes: list[PlanNode], final_schema: Sequence[str]) -> list[PlanNode]:
    """Cross-node common-subexpression elimination (exact).

    Two walks over the frame plan, both tracking a per-column *version
    token* so ``col("x")`` before and after an overwrite of ``x`` never
    aliases (:func:`repro_torch.core.expr.resolved_signature`). The first walk
    counts version-resolved occurrences of every non-leaf sub-expression
    across ``Project`` entries and ``Filter`` predicates; a sub-expression
    occurring at least twice is elected unless it only ever appears inside
    one strictly larger shared expression (then the larger one is elected
    instead). The second walk hoists each elected sub-expression into a
    synthetic ``__cse_<fp>`` Project entry at its first use and rewrites
    every consumer — later Project entries *and* Filter predicates — to
    read the memoized column, so a chain shared by a ``where`` and a
    derived column evaluates once per shard. Expression evaluation is
    row-local, so computing the intermediate at the earliest consumer and
    row-filtering it alongside every other buffer is value-preserving.
    A terminal ``Select`` keeps the synthetic columns out of the result
    schema; with an empty ``final_schema`` the pass is skipped (there is
    no terminal schema to hide them behind).
    Copy of ``repro/core/plan.py:397``.
    """
    if not final_schema:
        return nodes

    # A user ``Select`` between two consumers would drop the synthetic
    # column, so sharing is scoped to Select-free regions: occurrences key
    # on (region, signature) and a hoisted definition never outlives its
    # region.
    occ: dict[tuple[int, bytes], int] = {}
    parents: dict[tuple[int, bytes], set[bytes | None]] = {}

    def count(e: E.Expr, versions: dict, region: int, parent: bytes | None) -> None:
        if isinstance(e, (E.Col, E.Lit)):
            return
        sig = E.resolved_signature(e, versions)
        kids = [e.input] if isinstance(e, E.StrOp) else list(e.parts)
        for k in kids:
            count(k, versions, region, sig)
        if sig is not None:
            occ[region, sig] = occ.get((region, sig), 0) + 1
            parents.setdefault((region, sig), set()).add(parent)

    versions: dict[str, bytes | None] = {}
    region = 0
    for node in nodes:
        if isinstance(node, Select):
            region += 1
        elif isinstance(node, Project):
            for out_col, e in node.exprs:
                sig_e = E.resolved_signature(e, versions)
                count(e, versions, region, None)
                versions[out_col] = sig_e
        elif isinstance(node, Filter):
            for e in E.pred_exprs(node.pred):
                count(e, versions, region, None)

    selected: set[tuple[int, bytes]] = set()
    for (reg, sig), n in occ.items():
        if n < 2:
            continue
        ps = parents.get((reg, sig), set())
        if len(ps) == 1:
            (p,) = ps
            if p is not None and occ.get((reg, p), 0) >= 2:
                continue  # covered by a strictly larger shared expression
        selected.add((reg, sig))
    if not selected:
        return nodes

    defined: dict[tuple[int, bytes], str] = {}
    region = 0

    def rewrite(
        e: E.Expr, versions: dict, defs: list[tuple[str, E.Expr]]
    ) -> E.Expr:
        """Replace elected subtrees (signatures from the *original* tree)
        with references to their synthetic column, defining it at first
        use."""
        if isinstance(e, (E.Col, E.Lit)):
            return e
        sig = E.resolved_signature(e, versions)
        if isinstance(e, E.StrOp):
            new_in = rewrite(e.input, versions, defs)
            new_e: E.Expr = (
                e if new_in is e.input else E.StrOp(new_in, e.op, e.label)
            )
        else:  # Concat
            new_parts = tuple(rewrite(p, versions, defs) for p in e.parts)
            new_e = (
                e
                if all(a is b for a, b in zip(new_parts, e.parts))
                else E.Concat(new_parts, e.sep)
            )
        if sig is not None and (region, sig) in selected:
            name = defined.get((region, sig))
            if name is None:
                name = _cse_name(sig)
                defined[region, sig] = name
                defs.append((name, new_e))
            return E.Col(name)
        return new_e

    versions = {}
    out_nodes: list[PlanNode] = []
    for node in nodes:
        if isinstance(node, Select):
            region += 1
            out_nodes.append(node)
        elif isinstance(node, Project):
            entries: list[tuple[str, E.Expr]] = []
            for out_col, e in node.exprs:
                sig_e = E.resolved_signature(e, versions)
                defs: list[tuple[str, E.Expr]] = []
                new_e = rewrite(e, versions, defs)
                entries.extend(defs)
                entries.append((out_col, new_e))
                versions[out_col] = sig_e
            out_nodes.append(Project(tuple(entries)))
        elif isinstance(node, Filter):
            defs = []
            new_pred = E.map_pred_exprs(
                node.pred, lambda ex: rewrite(ex, versions, defs)
            )
            if defs:
                out_nodes.append(Project(tuple(defs)))
            out_nodes.append(Filter(new_pred))
        else:
            out_nodes.append(node)
    if not defined:
        return nodes
    return out_nodes + [Select(tuple(final_schema))]


def optimize_plan(
    nodes: Sequence[PlanNode], final_schema: Sequence[str] = ()
) -> list[PlanNode]:
    """Catalyst-style logical rewrites (exact: never change the result).
    Copy of ``repro/core/plan.py:530``."""
    out = _merge_adjacent(list(nodes))
    out = _pull_filters_back(out)
    out = _prune_and_project(out, final_schema)
    out = _cse_pass(out, final_schema)
    return _merge_adjacent(out)


def _node_signature(node: PlanNode) -> bytes:
    """Stable byte signature of one node (parameter-exact for expressions).
    Copy of ``repro/core/plan.py:541``."""
    if isinstance(node, Project):
        parts = [b"Project"]
        for out_col, e in node.exprs:
            parts.append(out_col.encode() + b"=" + e.signature())
        return b"|".join(parts)
    if isinstance(node, Filter):
        return b"Filter:" + node.pred.signature()
    if isinstance(node, SourceJsonDirs):
        # describe() elides the directory list; the fingerprint must not.
        return f"SourceJsonDirs({list(node.directories)}, {list(node.fields)})".encode()
    if isinstance(node, SourceFrame):
        return f"SourceFrame(rows={len(node.frame)}, fields={node.frame.field_names})".encode()
    if isinstance(node, Tokenize):
        # Spec parameters in full; tokenizer identity is deliberately
        # excluded — plan fingerprints key *preprocessing*, not
        # vocabularies (the token cache adds the vocab fingerprint).
        parts = [b"Tokenize"]
        for s in node.specs:
            parts.append(
                f"{s.column}->{s.name}:max_len={s.max_len}"
                f":start_end={s.add_start_end}".encode()
            )
        return b"|".join(parts)
    # Remaining nodes are fully described by their parameters.
    return node.describe().encode()


def plan_fingerprint(
    nodes: Sequence[PlanNode], final_schema: Sequence[str] = (), optimize: bool = True
) -> str:
    """Stable hex fingerprint of the (optimized) plan.

    Changes whenever any node or any stage op parameter changes; invariant
    under re-construction of an identical chain. The shard cache composes
    this per column (see :func:`repro_torch.core.executor.column_fingerprints`)
    with the source shard's bytes digest.
    Copy of ``repro/core/plan.py:570``.
    """
    frame_nodes, array_nodes = split_plan(nodes)
    if optimize:
        frame_nodes = optimize_plan(frame_nodes, final_schema)
    h = hashlib.blake2b(B.PORT_TAG, digest_size=16)
    for node in list(frame_nodes) + list(array_nodes):
        sig = _node_signature(node)
        h.update(len(sig).to_bytes(8, "little"))
        h.update(sig)
    return h.hexdigest()


def explain(
    nodes: Sequence[PlanNode],
    final_schema: Sequence[str] = (),
    optimize: bool = True,
    backend: str | None = None,
) -> str:
    """Copy of ``repro/core/plan.py:591``."""
    lines = ["== logical plan =="]
    lines += [f"  {i}: {n.describe()}" for i, n in enumerate(nodes)]
    if optimize:
        opt = optimize_plan(nodes, final_schema)
        lines.append("== optimized plan ==")
        lines += [f"  {i}: {n.describe()}" for i, n in enumerate(opt)]
    # Plan-level (explicit) backend choice only: the env var applies at
    # execution time and must not make explain() output non-deterministic.
    # Without one the port runs its default, ``device``.
    lines.append("== physical ==")
    lines.append(f"  bytes backend: {backend or 'device'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Whole-frame physical executor (with the paper's timing attribution)
# ---------------------------------------------------------------------------


def run_project_frame(
    frame: ColumnarFrame,
    compiled: Sequence[tuple[str, tuple]],
    workers: int = 1,
    backend: str | None = None,
    device=None,
) -> ColumnarFrame:
    """Whole-frame Project executor: flatten each input column once, run
    the compiled expression, unflatten once. Under a host backend pure op
    chains fan out over a spawned process pool by splitting the buffer on
    row boundaries (every byte op is row-local); the ``device`` backend
    runs in this process (``pipeline.check_workers``). Copy of
    ``repro/core/plan.py:615``."""
    import multiprocessing

    from .engine_config import EngineConfig
    from .pipeline import _run_ops, _split_on_rows, check_workers

    backend = EngineConfig(backend=backend).resolve_backend()
    check_workers(backend, workers)
    flat: dict[str, np.ndarray] = {}
    src_flat: dict[str, np.ndarray] = {}  # raw columns flatten at most once

    def lookup(c: str) -> np.ndarray:
        if c in flat:
            return flat[c]
        if c not in src_flat:
            src_flat[c] = frame.flat(c)
        return src_flat[c]

    pool = None
    if workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(max_workers=workers,
                                   mp_context=multiprocessing.get_context("spawn"))
    out = frame
    try:
        for out_col, comp in compiled:
            if comp[0] == "chain" and not comp[2]:
                buf = lookup(comp[1])  # pure alias (CSE consumer): no copy
            elif pool is not None and comp[0] == "chain":
                src = lookup(comp[1])
                chunks = _split_on_rows(src, workers)
                parts = list(
                    pool.map(_run_ops, [(list(comp[2]), c, backend) for c in chunks])
                )
                buf = np.concatenate(parts) if parts else src
            else:
                buf = E.eval_str(comp, lookup, len(frame), backend, device)
            flat[out_col] = buf
            out = out.ensure_column(out_col).with_flat(out_col, buf)
    finally:
        if pool is not None:
            pool.shutdown()
    return out


def _exec_frame_node(
    node: PlanNode,
    frame: ColumnarFrame | None,
    workers: int,
    optimize: bool,
    backend: str | None = None,
    device=None,
) -> ColumnarFrame:
    """Copy of ``repro/core/plan.py:664``."""
    if isinstance(node, SourceJsonDirs):
        return ing.ingest(node.directories, node.fields, workers=workers)
    if isinstance(node, SourceFrame):
        return node.frame
    assert frame is not None, "plan must start with a source node"
    if isinstance(node, Select):
        return frame.select(list(node.fields))
    if isinstance(node, DropNA):
        return frame.dropna(list(node.subset))
    if isinstance(node, DropDuplicates):
        return frame.drop_duplicates(list(node.subset))
    if isinstance(node, Project):
        compiled = E.compile_project(node.exprs, optimize)
        return run_project_frame(frame, compiled, workers=workers, backend=backend,
                                 device=device)
    if isinstance(node, Filter):
        comp = E.compile_pred(node.pred)
        if optimize:
            comp = E.fuse_compiled(comp)
        memo: dict[str, np.ndarray] = {}  # predicate leaves share one flatten

        def lk(c: str) -> np.ndarray:
            if c not in memo:
                memo[c] = frame.flat(c)
            return memo[c]

        keep = E.eval_mask(comp, lk, len(frame), backend, device)
        return frame if keep.all() else frame.take(keep)
    if isinstance(node, Split):
        train, val = split_indices(len(frame), node.fraction, node.seed)
        return frame.take(np.sort(train) if node.part == "train" else np.sort(val))
    raise ValueError(f"not a frame-level node: {node!r}")


def execute_frame_plan(
    nodes: Sequence[PlanNode],
    *,
    workers: int = 1,
    optimize: bool = True,
    final_schema: Sequence[str] = (),
    backend: str | None = None,
    device=None,
) -> tuple[ColumnarFrame, StageTimings]:
    """Run the frame-level plan whole-frame, attributing wall time to the
    paper's phases: source → ingestion, filters before the first stage chain
    → pre-cleaning, stage chains → cleaning, everything after → post-cleaning.

    ``optimize=False`` is the paper-faithful executor (no plan rewrites, no
    op fusion); ``optimize=True`` is the beyond-paper planned/fused path.
    Copy of ``repro/core/plan.py:704``.
    """
    frame_nodes, array_nodes = split_plan(nodes)
    if array_nodes:
        raise ValueError(f"array-level nodes in frame execution: {array_nodes}")
    if optimize:
        frame_nodes = optimize_plan(frame_nodes, final_schema)
    return continue_frame_plan(
        None,
        StageTimings(),
        frame_nodes,
        workers=workers,
        optimize=optimize,
        backend=backend,
        device=device,
    )


def continue_frame_plan(
    frame: ColumnarFrame | None,
    timings: StageTimings,
    nodes: Sequence[PlanNode],
    *,
    workers: int = 1,
    optimize: bool = True,
    seen_cleaning: bool = False,
    backend: str | None = None,
    device=None,
) -> tuple[ColumnarFrame, StageTimings]:
    """Run ``nodes`` starting from an already-materialized ``frame`` (or from
    scratch when ``frame`` is None), accumulating onto a copy of ``timings``.
    This is how a derived plan resumes from a memoized prefix instead of
    re-ingesting. Copy of
    ``repro/core/plan.py:734``."""
    t = StageTimings(
        timings.ingestion,
        timings.pre_cleaning,
        timings.cleaning,
        timings.post_cleaning,
        timings.tokenize,
    )
    for node in nodes:
        t0 = time.perf_counter()
        frame = _exec_frame_node(node, frame, workers, optimize, backend, device)
        dt = time.perf_counter() - t0
        if isinstance(node, (SourceJsonDirs, SourceFrame)):
            t.ingestion += dt
        elif isinstance(node, Project):
            seen_cleaning = True
            t.cleaning += dt
        elif seen_cleaning:
            t.post_cleaning += dt
        else:
            t.pre_cleaning += dt
    assert frame is not None, "empty plan"
    return frame, t


def execute_array_nodes(
    frame: ColumnarFrame, array_nodes: Sequence[PlanNode]
) -> dict[str, np.ndarray]:
    """Materialize the Tokenize node of the array-level suffix whole-frame.
    Copy of ``repro/core/plan.py:772``."""
    tok = next((n for n in array_nodes if isinstance(n, Tokenize)), None)
    if tok is None:
        raise ValueError("plan has no Tokenize node; add .tokenize(...) first")
    columns = {spec.column: frame[spec.column] for spec in tok.specs}
    return encode_frame_columns(columns, tok.tokenizer, tok.specs)


# ---------------------------------------------------------------------------
# Streaming physical executor: per-shard over a shard executor
# ---------------------------------------------------------------------------


def _drain_bucketed(
    pool: dict[str, np.ndarray],
    order: np.ndarray,
    batch: Batch,
    rng: np.random.Generator,
    final: bool,
) -> tuple[list[dict[str, np.ndarray]], dict[str, np.ndarray] | None]:
    """Bucketed drain: (emitted batches, carry rows). Full batches are
    per-bucket-cell, sliced to the cell widths; per-cell remainders carry
    to the next window, or on the final drain follow the batch node's
    remainder policy (shared ``emit_remainders``). When shuffling, the
    emitted batch order is permuted too — matching the whole-frame
    assembler — so the stream is not a systematic short-to-long length
    run within every window. Copy of
    ``repro/core/plan.py:788``."""
    from ..data.batching import bucket_grid, emit_remainders

    _, buckets = bucket_grid(batch.bucket_by, batch.buckets, pool)
    out, rest = emit_bucketed(pool, order, batch.batch_size, batch.bucket_by, buckets)
    carry: dict[str, np.ndarray] | None = None
    if rest.size:
        rest_rows = {k: v[rest] for k, v in pool.items()}
        if not final:
            carry = rest_rows
        else:
            out.extend(
                emit_remainders(
                    rest_rows, batch.bucket_by, buckets,
                    batch.pad_to, batch.drop_remainder,
                )
            )
    if batch.shuffle:
        rng.shuffle(out)
    return out, carry


def _batched(
    chunks: Iterator[dict[str, np.ndarray]],
    batch: Batch,
    rng: np.random.Generator,
    shuffle_buffer: int,
) -> Iterator[dict[str, np.ndarray]]:
    """Accumulate per-shard arrays and slice fixed-size batches; when
    shuffling, permute within a bounded buffer (streaming cannot see the
    whole epoch, so this is windowed shuffle a la tf.data). With a
    bucketed batch node, rows group by payload length within the same
    window (windowed bucketing a la tf.data bucket_by_sequence_length). Copy of
    ``repro/core/plan.py:823``."""
    parts: list[dict[str, np.ndarray]] = []
    n_buf = 0
    threshold = shuffle_buffer if batch.shuffle else batch.batch_size

    def drain(final: bool) -> Iterator[dict[str, np.ndarray]]:
        nonlocal parts, n_buf
        if not parts:
            return
        keys = parts[0].keys()
        pool = {k: np.concatenate([p[k] for p in parts]) for k in keys}
        parts, n_buf = [], 0
        n = len(next(iter(pool.values())))
        order = rng.permutation(n) if batch.shuffle else np.arange(n)
        if batch.bucket_by is not None:
            out, carry = _drain_bucketed(pool, order, batch, rng, final)
            if carry is not None:
                parts, n_buf = [carry], len(next(iter(carry.values())))
            yield from out
            return
        if batch.shuffle:
            pool = {k: v[order] for k, v in pool.items()}
        full_stop = (n // batch.batch_size) * batch.batch_size
        for s in range(0, full_stop, batch.batch_size):
            yield {k: v[s : s + batch.batch_size] for k, v in pool.items()}
        if full_stop < n:
            rest = {k: v[full_stop:] for k, v in pool.items()}
            if not final:
                parts, n_buf = [rest], n - full_stop
            elif batch.pad_to is not None:
                yield pad_batch(rest, batch.pad_to)
            elif not batch.drop_remainder:
                yield rest

    for chunk in chunks:
        if not len(next(iter(chunk.values()))):
            continue
        parts.append(chunk)
        n_buf += len(next(iter(chunk.values())))
        if n_buf >= threshold:
            yield from drain(final=False)
    yield from drain(final=True)


def stream_batches(
    nodes: Sequence[PlanNode],
    *,
    workers: int = 2,
    optimize: bool = True,
    epochs: int | None = 1,
    shuffle_buffer: int | None = None,
    final_schema: Sequence[str] = (),
    executor: str | None = None,
    cache_dir: str | Path | None = None,
    stats: dict | None = None,
    remote: Any = None,
    backend: str | None = None,
    device=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Per-shard streaming execution: parse → filter → clean each shard
    on the thread shard executor (see
    :func:`repro_torch.core.executor.make_executor`), then tokenize and batch
    across shard boundaries.

    Preprocessing of shard k+1 overlaps consumption of shard k, so when the
    resulting iterator feeds an AsyncLoader the host pipeline runs fully
    concurrent with device compute. Shard results complete in work-stealing
    order but are reassembled in *shard* order by the consumer (a small heap,
    bounded by the in-flight shard count), so the batch stream is
    deterministic run-to-run and across executors; records additionally
    match whole-frame execution as a multiset.
    Full-subset dedup keeps that guarantee directly — duplicate rows are
    interchangeable. A *partial*-subset drop_duplicates (where the variant
    that survives matters) streams via the two-pass canonical-survivor
    protocol instead: an election pass picks each key's whole-frame
    keep-first row, then every epoch runs the pure per-shard ``dedup_take``
    program (see :func:`repro_torch.core.executor.split_dedup_programs`). Only a
    partial dedup *stacked with another dedup* is rejected.

    ``cache_dir`` enables the plan-fingerprint shard cache; ``executor``
    is ``"thread"`` (the port's one shard executor; ``"process"`` and
    ``"remote"`` raise), ``device`` is where the ``device`` backend's scan
    passes run. When ``stats`` is a dict it receives
    ``executor``, ``cache_hits``, ``cache_misses`` and per-epoch ``timings``
    after each epoch completes.
    Copy of ``repro/core/plan.py:877``.
    """
    from ..analysis import PlanValidationError, check_streaming_plan
    from . import executor as EX

    frame_nodes, array_nodes = split_plan(nodes)
    if optimize:
        frame_nodes = optimize_plan(frame_nodes, final_schema)

    # Static shape validation against the same (optimized) frame plan this
    # function streams — every failure below surfaces here as a coded,
    # provenance-bearing diagnostic before any shard executor spawns.
    shape_errors = [
        d
        for d in check_streaming_plan(nodes, optimized_frame_nodes=frame_nodes)
        if d.severity == "error"
    ]
    if shape_errors:
        raise PlanValidationError(shape_errors)

    # Backstop raises: unreachable via the public API (the analyzer above
    # rejects these shapes first); kept so a bypassed or regressed analyzer
    # still fails loudly instead of executing a malformed plan.
    src = frame_nodes[0]
    if not isinstance(src, SourceJsonDirs):
        raise ValueError("streaming execution requires a SourceJsonDirs plan")
    if any(isinstance(n, Split) for n in frame_nodes):
        raise ValueError("Split is whole-frame only; drop .prefetch() or .split()")
    tok = next((n for n in array_nodes if isinstance(n, Tokenize)), None)
    batch = next((n for n in array_nodes if isinstance(n, Batch)), None)
    if tok is None or batch is None:
        raise ValueError("streaming needs .tokenize(...) and .batch(...) in the plan")

    dedups = [n for n in frame_nodes[1:] if isinstance(n, DropDuplicates)]
    partial = [d for d in dedups if not set(d.subset) >= set(src.fields)]
    if partial and len(dedups) > 1:
        # The election pass for one partial dedup would itself run under
        # the scheduling-dependent cross-shard state of the other.
        raise ValueError(
            f"streaming drop_duplicates({list(partial[0].subset)}) with "
            f"partial subsets cannot stack with another drop_duplicates; "
            f"drop .prefetch() for whole-frame execution"
        )

    shards = ing.list_shards(src.directories)
    # Compile the per-shard program once — token encoding included, so the
    # executor's reader threads emit int32 token
    # buffers and the consumer never runs a per-word Python loop.
    spec_cols = tuple(dict.fromkeys(spec.column for spec in tok.specs))
    token_plan = EX.TokenPlan(
        specs=tuple(tok.specs),
        stoi=dict(tok.tokenizer.stoi),
        vocab_fp=tok.tokenizer.fingerprint,
    )
    row_filters = None
    if partial:
        # Two-pass canonical-survivor protocol (shared with fit_vocab):
        # elect the whole-frame keep-first survivor rows once, then every
        # epoch streams the pure per-shard dedup_take program — identical
        # multiset to whole-frame execution on any executor.
        pass1, program = EX.split_dedup_programs(
            frame_nodes,
            optimize=optimize,
            output_columns=spec_cols,
            tokens=token_plan,
            backend=backend,
            device=device,
        )
        row_filters = EX.elect_survivors(
            shards,
            pass1,
            dict(
                workers=max(workers, 1),
                cache_dir=cache_dir,
                executor=executor,
                remote=remote,
            ),
            stats,
        )
    else:
        program = EX.compile_shard_program(
            frame_nodes,
            optimize=optimize,
            output_columns=spec_cols,
            tokens=token_plan,
            backend=backend,
            device=device,
        )

    epoch = 0
    while epochs is None or epoch < epochs:
        exec_ = EX.make_executor(
            shards,
            program,
            workers=max(workers, 1),
            cache_dir=cache_dir,
            executor=executor,
            remote=remote,
            row_filters=row_filters,
        )

        def chunks() -> Iterator[dict[str, np.ndarray]]:
            # Reassemble completion-ordered results in *shard* order via a
            # small heap (bounded by in-flight shards ≈ workers), so the
            # downstream bucketing/batching sees a deterministic row stream
            # and iter_batches is reproducible run-to-run regardless of
            # executor choice or work-stealing schedule.
            heap: list[tuple[int, int, dict[str, np.ndarray]]] = []
            seq = 0  # tiebreak: dict payloads are not comparable
            next_idx = 0
            for res in exec_:
                heapq.heappush(heap, (res.shard_index, seq, res.tokens))
                seq += 1
                while heap and heap[0][0] == next_idx:
                    yield heapq.heappop(heap)[2]
                    next_idx += 1
            while heap:  # defensive: drain any gap in shard indexes
                yield heapq.heappop(heap)[2]

        rng = np.random.default_rng(batch.seed + epoch)
        buffer = shuffle_buffer or max(8 * batch.batch_size, 1024)
        produced = 0
        try:
            for b in _batched(chunks(), batch, rng, buffer):
                produced += 1
                yield b
        finally:
            # Abandoned mid-epoch (consumer broke out / AsyncLoader closed):
            # stop the workers instead of preprocessing the rest of the
            # corpus into a queue nobody drains.
            exec_.stop()
            if stats is not None:
                stats["executor"] = exec_.name
                stats["cache_hits"] = stats.get("cache_hits", 0) + exec_.cache_hits
                stats["cache_misses"] = (
                    stats.get("cache_misses", 0) + exec_.cache_misses
                )
                stats["token_cache_hits"] = (
                    stats.get("token_cache_hits", 0) + exec_.token_cache_hits
                )
                stats["token_cache_misses"] = (
                    stats.get("token_cache_misses", 0) + exec_.token_cache_misses
                )
                stats["timings"] = exec_.timings
        if not produced:
            return  # empty epoch: stop instead of re-reading the corpus forever
        epoch += 1
