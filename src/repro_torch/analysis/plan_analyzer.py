"""Plan analyzer: typed schema inference and streaming-shape checks.

Copy of ``repro/analysis/plan_analyzer.py`` (the whole file).
:func:`infer_schema` walks the node list tracking each column's type
(``"str"`` text, ``"tokens"`` int32 token output);
:func:`check_streaming_plan` re-derives every shape requirement of
:func:`repro_torch.core.plan.stream_batches` against the optimized frame
plan, so ``Dataset.validate()`` rejects exactly the plans execution would,
before a shard reader starts; :func:`analyze_plan` is the composite entry
point. Codes (``E0xx`` from :mod:`expr_check`, ``P010+`` from
:mod:`rewrites`):

* ``P001``: streaming requires a ``SourceJsonDirs`` plan
* ``P002``: ``Split`` cannot stream
* ``P003`` / ``P004``: streaming missing ``Tokenize`` / ``Batch``
* ``P005``: partial-subset dedup stacked with another dedup
* ``P006``: node reads a column the schema does not hold
* ``P007``: frame-level node after an array-level node
* ``P008``: invalid Tokenize/Batch/Prefetch configuration
* ``P009``: off-grid bucket widths
* ``P014``: plan does not start with a source node
* ``P016``: plan not row-program-eligible (:func:`check_row_program_plan`;
  the port's ``Dataset`` has no ``row_program`` yet)
"""

from __future__ import annotations

from typing import Sequence

from ..core import plan as P
from .diagnostics import Diagnostic, node_ref
from .expr_check import check_predicate, check_transform


def _source_fields(node: P.PlanNode) -> tuple[str, ...] | None:
    """Copy of ``repro/analysis/plan_analyzer.py:41``."""
    if isinstance(node, P.SourceJsonDirs):
        return node.fields
    if isinstance(node, P.SourceFrame):
        return tuple(node.frame.field_names)
    return None


def _unknown(cols, schema: dict[str, str]) -> list[str]:
    """Copy of ``repro/analysis/plan_analyzer.py:49``."""
    return sorted(c for c in cols if c not in schema)


def infer_schema(
    nodes: Sequence[P.PlanNode],
) -> tuple[dict[str, str], list[Diagnostic]]:
    """Walk the plan inferring ``{column: "str" | "tokens"}``; collect
    every schema/shape/typing diagnostic along the way. Copy of
    ``repro/analysis/plan_analyzer.py:53``."""
    nodes = list(nodes)
    diags: list[Diagnostic] = []
    if not nodes or _source_fields(nodes[0]) is None:
        ref = (node_ref(0, nodes[0]),) if nodes else ()
        diags.append(
            Diagnostic(
                "P014",
                "plan must start with a source node (SourceJsonDirs or "
                "SourceFrame)",
                provenance=ref,
            )
        )
        return {}, diags

    columns: dict[str, str] = {f: "str" for f in _source_fields(nodes[0]) or ()}
    first_array: tuple[int, P.PlanNode] | None = None
    tok: P.Tokenize | None = None

    for i, node in enumerate(nodes[1:], start=1):
        ref = (node_ref(i, node),)
        if _source_fields(node) is not None:
            diags.append(
                Diagnostic(
                    "P014", "second source node mid-plan", provenance=ref
                )
            )
            continue
        if P.is_frame_node(node):
            if first_array is not None:
                fi, fn = first_array
                diags.append(
                    Diagnostic(
                        "P007",
                        f"frame-level {type(node).__name__} after array-level "
                        f"{type(fn).__name__}; frame verbs must come before "
                        "tokenize/batch/prefetch",
                        provenance=(node_ref(fi, fn), node_ref(i, node)),
                    )
                )
                continue  # don't cascade column checks against token schema
            if isinstance(node, P.Select):
                unknown = _unknown(node.fields, columns)
                if unknown:
                    diags.append(
                        Diagnostic(
                            "P006",
                            f"Select reads unknown column(s) {unknown}; "
                            f"columns here are {sorted(columns)}",
                            provenance=ref,
                        )
                    )
                columns = {c: columns[c] for c in node.fields if c in columns}
            elif isinstance(node, (P.DropNA, P.DropDuplicates)):
                unknown = _unknown(node.subset, columns)
                if unknown:
                    diags.append(
                        Diagnostic(
                            "P006",
                            f"{type(node).__name__} reads unknown column(s) "
                            f"{unknown}; columns here are {sorted(columns)}",
                            provenance=ref,
                        )
                    )
            elif isinstance(node, P.Project):
                for out_col, e in node.exprs:
                    diags += check_transform(out_col, e, columns, ref)
                    columns[out_col] = "str"
            elif isinstance(node, P.Filter):
                diags += check_predicate(node.pred, columns, ref)
            # Split: row partition, schema unchanged.
            continue

        # -- array-level suffix ------------------------------------------
        if first_array is None:
            first_array = (i, node)
        if isinstance(node, P.Tokenize):
            if tok is not None:
                diags.append(
                    Diagnostic(
                        "P008",
                        "second Tokenize node in the plan; one plan encodes "
                        "one token spec set",
                        provenance=ref,
                    )
                )
            for spec in node.specs:
                if columns.get(spec.column) != "str":
                    diags.append(
                        Diagnostic(
                            "P006",
                            f"tokenize spec {spec.name!r} reads "
                            f"{spec.column!r}, which is not a text column "
                            f"here; columns are {sorted(columns)}",
                            provenance=ref,
                        )
                    )
                if spec.max_len < 1:
                    diags.append(
                        Diagnostic(
                            "P008",
                            f"tokenize spec {spec.name!r} has max_len="
                            f"{spec.max_len}; must be >= 1",
                            provenance=ref,
                        )
                    )
            tok = node
            columns = {s.name: "tokens" for s in node.specs}
        elif isinstance(node, P.Batch):
            diags += _check_batch(node, tok, columns, ref)
        elif isinstance(node, P.Prefetch):
            if node.prefetch < 1:
                diags.append(
                    Diagnostic(
                        "P008",
                        f"Prefetch depth {node.prefetch}; must be >= 1",
                        provenance=ref,
                    )
                )
    return columns, diags


def _check_batch(
    node: P.Batch,
    tok: P.Tokenize | None,
    columns: dict[str, str],
    ref: tuple[str, ...],
) -> list[Diagnostic]:
    """Copy of ``repro/analysis/plan_analyzer.py:179``."""
    diags: list[Diagnostic] = []
    if node.batch_size < 1:
        diags.append(
            Diagnostic(
                "P008",
                f"batch_size={node.batch_size}; must be >= 1",
                provenance=ref,
            )
        )
    if tok is None:
        diags.append(
            Diagnostic(
                "P008",
                "Batch requires a Tokenize node earlier in the plan "
                "(batches are assembled from token arrays)",
                provenance=ref,
            )
        )
        return diags
    if node.bucket_by is None:
        return diags
    bcols = (
        (node.bucket_by,) if isinstance(node.bucket_by, str) else tuple(node.bucket_by)
    )
    specs_by_name = {s.name: s for s in tok.specs}
    for c in bcols:
        if columns.get(c) != "tokens":
            diags.append(
                Diagnostic(
                    "P008",
                    f"bucket_by={c!r} is not a token output; available: "
                    f"{sorted(specs_by_name)}",
                    provenance=ref,
                )
            )
    if not node.buckets:
        return diags
    widths_per_col: tuple = (
        (node.buckets,)
        if node.buckets and isinstance(node.buckets[0], int)
        else tuple(node.buckets)
    )
    if len(widths_per_col) != len(bcols):
        diags.append(
            Diagnostic(
                "P008",
                f"{len(widths_per_col)} bucket width list(s) for "
                f"{len(bcols)} bucket column(s)",
                provenance=ref,
            )
        )
        return diags
    for c, widths in zip(bcols, widths_per_col):
        spec = specs_by_name.get(c)
        ws = tuple(widths)
        if not ws:
            continue
        if list(ws) != sorted(set(ws)) or ws[0] < 1:
            diags.append(
                Diagnostic(
                    "P009",
                    f"bucket widths for {c!r} must be strictly increasing "
                    f"and >= 1, got {list(ws)}",
                    provenance=ref,
                )
            )
        elif spec is not None and ws[-1] < spec.max_len:
            diags.append(
                Diagnostic(
                    "P009",
                    f"top bucket width {ws[-1]} for {c!r} is below the "
                    f"spec's max_len={spec.max_len}; the longest rows would "
                    "not fit any bucket",
                    provenance=ref,
                )
            )
    return diags


def check_streaming_plan(
    nodes: Sequence[P.PlanNode],
    *,
    final_schema: Sequence[str] = (),
    optimize: bool = True,
    optimized_frame_nodes: Sequence[P.PlanNode] | None = None,
) -> list[Diagnostic]:
    """The shape requirements of :func:`repro_torch.core.plan.stream_batches`,
    as diagnostics. Evaluated against the optimized frame plan (pass
    ``optimized_frame_nodes`` to reuse one already computed) because
    that is what streams — e.g. source narrowing can turn a
    partial-subset dedup into a full-subset one. Copy of
    ``repro/analysis/plan_analyzer.py:264``."""
    nodes = list(nodes)
    diags: list[Diagnostic] = []
    frame_nodes, array_nodes = P.split_plan(nodes)
    if optimized_frame_nodes is not None:
        frame_nodes = list(optimized_frame_nodes)
    elif optimize:
        try:
            frame_nodes = P.optimize_plan(frame_nodes, final_schema)
        except Exception:  # noqa: BLE001 - malformed plan: check unoptimized
            pass

    src = frame_nodes[0] if frame_nodes else None
    if not isinstance(src, P.SourceJsonDirs):
        ref = (node_ref(0, nodes[0]),) if nodes else ()
        diags.append(
            Diagnostic(
                "P001",
                "streaming execution requires a SourceJsonDirs plan "
                "(an in-memory frame has no shards to stream)",
                provenance=ref,
            )
        )
    splits = [(i, n) for i, n in enumerate(nodes) if isinstance(n, P.Split)]
    if splits:
        diags.append(
            Diagnostic(
                "P002",
                "Split is whole-frame only; drop .prefetch() or .split()",
                provenance=tuple(node_ref(i, n) for i, n in splits),
            )
        )
    tok = next((n for n in array_nodes if isinstance(n, P.Tokenize)), None)
    batch = next((n for n in array_nodes if isinstance(n, P.Batch)), None)
    # Provenance for a *missing* node points at what makes the plan stream:
    # the Prefetch node when there is one, else the source.
    stream_ref = next(
        (
            (node_ref(i, n),)
            for i, n in enumerate(nodes)
            if isinstance(n, P.Prefetch)
        ),
        (node_ref(0, nodes[0]),) if nodes else (),
    )
    if tok is None:
        diags.append(
            Diagnostic(
                "P003",
                "streaming needs .tokenize(...) in the plan (executors emit "
                "token buffers, not raw text)",
                provenance=stream_ref,
            )
        )
    if batch is None:
        diags.append(
            Diagnostic(
                "P004",
                "streaming needs .batch(...) in the plan",
                provenance=stream_ref,
            )
        )
    if isinstance(src, P.SourceJsonDirs):
        dedups = [n for n in frame_nodes[1:] if isinstance(n, P.DropDuplicates)]
        partial = [d for d in dedups if not set(d.subset) >= set(src.fields)]
        if partial and len(dedups) > 1:
            # Provenance names the stacked Dedup nodes at their *logical*
            # plan positions (the optimizer never adds or removes dedups).
            refs = tuple(
                node_ref(i, n)
                for i, n in enumerate(nodes)
                if isinstance(n, P.DropDuplicates)
            )
            diags.append(
                Diagnostic(
                    "P005",
                    f"streaming drop_duplicates({list(partial[0].subset)}) "
                    "with partial subsets cannot stack with another "
                    "drop_duplicates; drop .prefetch() for whole-frame "
                    "execution",
                    provenance=refs,
                )
            )
    return diags


def check_row_program_plan(nodes: Sequence[P.PlanNode]) -> list[Diagnostic]:
    """Row-program eligibility (``Dataset.row_program()``): every step must
    be executable on a single row in isolation.

    A served request is one row; anything that consults other rows
    (``drop_duplicates`` — cross-row keep-first state), partitions the
    whole frame (``split``), or changes batch assembly (``batch`` /
    ``prefetch`` are simply ignored — they shape training streams, not
    per-request encoding) cannot be part of the request path. The plan
    must also start from ``SourceJsonDirs`` (the shard-program compiler's
    contract — field names come from the source) and carry a ``Tokenize``
    node, because a row program's output is token arrays.
    Copy of ``repro/analysis/plan_analyzer.py:360``.
    """
    nodes = list(nodes)
    diags: list[Diagnostic] = []
    if not nodes or not isinstance(nodes[0], P.SourceJsonDirs):
        ref = (node_ref(0, nodes[0]),) if nodes else ()
        diags.append(
            Diagnostic(
                "P016",
                "row programs require a SourceJsonDirs plan (field names and "
                "the shard-program compiler both come from the source)",
                provenance=ref,
            )
        )
    for i, node in enumerate(nodes):
        ref = (node_ref(i, node),)
        if isinstance(node, P.DropDuplicates):
            diags.append(
                Diagnostic(
                    "P016",
                    "drop_duplicates holds cross-row keep-first state; a "
                    "single served request cannot evaluate it — drop it from "
                    "the serving chain",
                    provenance=ref,
                )
            )
        elif isinstance(node, P.Split):
            diags.append(
                Diagnostic(
                    "P016",
                    "split partitions the whole frame; not row-executable",
                    provenance=ref,
                )
            )
    if not any(isinstance(n, P.Tokenize) for n in nodes):
        ref = (node_ref(0, nodes[0]),) if nodes else ()
        diags.append(
            Diagnostic(
                "P016",
                "row programs encode requests to token arrays; add "
                ".tokenize(...) to the chain",
                provenance=ref,
            )
        )
    return diags


def analyze_plan(
    nodes: Sequence[P.PlanNode],
    *,
    final_schema: Sequence[str] = (),
    streaming: bool = False,
    optimize: bool = True,
) -> list[Diagnostic]:
    """Full static analysis of one plan: schema/type inference, streaming
    shape checks (when the plan would stream), and — on an otherwise clean
    plan — rewrite verification of the optimizer's output. Returns every
    diagnostic; callers decide whether warnings block. Copy of
    ``repro/analysis/plan_analyzer.py:418``."""
    from .rewrites import verify_plan_rewrites

    nodes = list(nodes)
    _, diags = infer_schema(nodes)
    if streaming:
        diags += check_streaming_plan(
            nodes, final_schema=final_schema, optimize=optimize
        )
    if optimize and not any(d.severity == "error" for d in diags) and nodes:
        frame_nodes, _ = P.split_plan(nodes)
        diags += verify_plan_rewrites(frame_nodes, final_schema)
    return diags
