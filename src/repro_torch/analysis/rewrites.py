"""Static rewrite verifier: every optimizer rewrite re-checked for value
preservation before anything executes.

Copy of ``repro/analysis/rewrites.py`` (the whole file). It walks the
logical and the optimized frame plans in parallel, tracking a per-column
version (an alias-transparent resolved signature of what the column
holds), and compares what a correct rewrite must preserve: the row-filter
conjuncts per era (``P012``), the ``DropDuplicates`` sequence and its key
versions (``P015``), every final column's version (``P011`` lost, ``P013``
changed) and the optimized plan's column scoping (``P010``).
Unfingerprintable subtrees (lambda word predicates) resolve to ``None``
and are left out of the comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..core import bytesops as B
from ..core import expr as E
from ..core import plan as P
from .diagnostics import Diagnostic, node_ref

_MISSING = b"<missing>"


def _len_prefixed(parts: Sequence[bytes]) -> bytes:
    """Copy of ``repro/analysis/rewrites.py:47``."""
    return b"".join(len(p).to_bytes(8, "little") + p for p in parts)


def _resolve_expr(e, versions: dict[str, bytes | None]) -> bytes | None:
    """Alias-transparent version-resolved signature (None = unverifiable).
    Copy of ``repro/analysis/rewrites.py:51``."""
    if isinstance(e, E.Col):
        return versions.get(e.name, b"src:" + e.name.encode())
    if isinstance(e, E.Lit):
        return e.signature()
    if isinstance(e, E.StrOp):
        base = _resolve_expr(e.input, versions)
        if base is None:
            return None
        try:
            osig = B.op_signature(e.op)
        except B.UnfingerprintableOpError:
            return None
        return _len_prefixed([base, b"op:" + osig])
    if isinstance(e, E.Concat):
        parts = [_resolve_expr(p, versions) for p in e.parts]
        if any(s is None for s in parts):
            return None
        return b"concat:" + e.sep.encode() + b":" + _len_prefixed(
            [s for s in parts if s is not None]
        )
    return None


def _resolve_pred(p, versions: dict[str, bytes | None]) -> bytes | None:
    """Copy of ``repro/analysis/rewrites.py:76``."""
    if isinstance(p, E.NotEmpty):
        base = _resolve_expr(p.input, versions)
        return None if base is None else b"notempty:" + base
    if isinstance(p, E.Contains):
        base = _resolve_expr(p.input, versions)
        if base is None:
            return None
        return b"contains:" + p.needle.encode() + b":" + base
    if isinstance(p, E.Compare):
        base = _resolve_expr(p.left.input, versions)
        if base is None:
            return None
        return b"wc" + p.op.encode() + str(p.right).encode() + b":" + base
    if isinstance(p, E.BoolOp):
        left = _resolve_pred(p.left, versions)
        right = _resolve_pred(p.right, versions)
        if left is None or right is None:
            return None
        return p.kind.encode() + b":" + _len_prefixed([left, right])
    if isinstance(p, E.NotOp):
        base = _resolve_pred(p.input, versions)
        return None if base is None else b"not:" + base
    return None


@dataclass
class _WalkState:
    """Everything a correct rewrite must preserve, from one plan walk.
    Copy of ``repro/analysis/rewrites.py:103``."""

    final: dict[str, bytes | None] = field(default_factory=dict)
    # (era, resolved conjunct signature) — row filters, DropNA included
    conjuncts: list[tuple[int, bytes]] = field(default_factory=list)
    unverifiable: int = 0  # conjuncts that resolved to None
    # ordered DropDuplicates records: (subset names, subset col versions)
    dedups: list[tuple[tuple[str, ...], tuple[bytes, ...]]] = field(
        default_factory=list
    )
    # (node index, node, missing column names) — reads of undefined columns
    undefined: list[tuple[int, object, list[str]]] = field(default_factory=list)


def _walk(frame_nodes: Sequence[P.PlanNode]) -> _WalkState:
    """Copy of ``repro/analysis/rewrites.py:118``."""
    st = _WalkState()
    versions: dict[str, bytes | None] = {}
    era = 0
    if not frame_nodes:
        return st
    src = frame_nodes[0]
    if isinstance(src, P.SourceJsonDirs):
        fields: tuple[str, ...] = src.fields
    elif isinstance(src, P.SourceFrame):
        fields = tuple(src.frame.field_names)
    else:
        fields = ()
    versions = {f: b"src:" + f.encode() for f in fields}

    def missing(cols) -> list[str]:
        return sorted(c for c in cols if c not in versions)

    def conjunct(sig: bytes | None) -> None:
        if sig is None:
            st.unverifiable += 1
        else:
            st.conjuncts.append((era, sig))

    for i, node in enumerate(frame_nodes[1:], start=1):
        if isinstance(node, P.Select):
            miss = missing(node.fields)
            if miss:
                st.undefined.append((i, node, miss))
            versions = {c: versions[c] for c in node.fields if c in versions}
        elif isinstance(node, P.DropNA):
            miss = missing(node.subset)
            if miss:
                st.undefined.append((i, node, miss))
            for c in node.subset:
                v = versions.get(c, _MISSING)
                conjunct(None if v is None else b"dropna:" + v)
        elif isinstance(node, P.Filter):
            if not isinstance(node.pred, E.Pred):
                conjunct(None)
                continue
            miss = missing(node.pred.inputs())
            if miss:
                st.undefined.append((i, node, miss))
            for conj in E.split_conjuncts(node.pred):
                conjunct(_resolve_pred(conj, versions))
        elif isinstance(node, P.DropDuplicates):
            miss = missing(node.subset)
            if miss:
                st.undefined.append((i, node, miss))
            # None (unverifiable) maps to a fixed token; signatures are
            # never empty, so ``or`` is safe here.
            sigs = tuple(
                versions.get(c, _MISSING) or b"<?>" for c in node.subset
            )
            st.dedups.append((tuple(node.subset), sigs))
            era += 1
        elif isinstance(node, P.Project):
            for out_col, e in node.exprs:
                if isinstance(e, E.Expr):
                    miss = missing(e.inputs())
                    if miss:
                        st.undefined.append((i, node, miss))
                    versions[out_col] = _resolve_expr(e, versions)
                else:
                    versions[out_col] = None
        elif isinstance(node, P.Split):
            era += 1
    st.final = versions
    return st


def verify_rewrite_pair(
    logical: Sequence[P.PlanNode],
    optimized: Sequence[P.PlanNode],
    final_schema: Sequence[str] = (),
) -> list[Diagnostic]:
    """Compare a logical frame plan against a claimed-equivalent rewrite.
    Copy of ``repro/analysis/rewrites.py:190``."""
    diags: list[Diagnostic] = []
    lst = _walk(list(logical))
    ost = _walk(list(optimized))

    for i, node, miss in ost.undefined:
        diags.append(
            Diagnostic(
                "P010",
                f"optimized plan reads column(s) {miss} no prior node defines "
                "(rewrite broke column scoping)",
                provenance=(node_ref(i, node),),
            )
        )

    # Row-filter conjuncts per era: filters are idempotent and commute
    # within an era, so compare as sets of resolved signatures.
    eras = {e for e, _ in lst.conjuncts} | {e for e, _ in ost.conjuncts}
    for era in sorted(eras):
        lset = {s for e, s in lst.conjuncts if e == era}
        oset = {s for e, s in ost.conjuncts if e == era}
        if lset != oset:
            dropped = len(lset - oset)
            added = len(oset - lset)
            diags.append(
                Diagnostic(
                    "P012",
                    f"rewrite changed the row-filter set in plan era {era}: "
                    f"{dropped} conjunct(s) dropped, {added} added — rows "
                    "would survive differently",
                )
            )
    if lst.unverifiable != ost.unverifiable:
        diags.append(
            Diagnostic(
                "P012",
                f"rewrite changed the number of unverifiable conjuncts "
                f"({lst.unverifiable} -> {ost.unverifiable}); equivalence "
                "cannot be established for them",
                severity="warning",
            )
        )

    if [d[0] for d in lst.dedups] != [d[0] for d in ost.dedups]:
        diags.append(
            Diagnostic(
                "P015",
                f"rewrite changed the DropDuplicates sequence: "
                f"{[list(d[0]) for d in lst.dedups]} -> "
                f"{[list(d[0]) for d in ost.dedups]}",
            )
        )
    else:
        for (subset, lsigs), (_, osigs) in zip(lst.dedups, ost.dedups):
            if lsigs != osigs:
                diags.append(
                    Diagnostic(
                        "P015",
                        f"rewrite changed what DropDuplicates({list(subset)}) "
                        "keys on: the dedup key columns hold different values "
                        "at that point of the rewritten plan",
                    )
                )

    for c in final_schema:
        lv = lst.final.get(c, _MISSING)
        ov = ost.final.get(c, _MISSING)
        if lv is _MISSING:
            continue  # the logical plan never produced it (schema drift
            # upstream — infer_schema reports that as P006)
        if ov is _MISSING:
            diags.append(
                Diagnostic(
                    "P011",
                    f"rewrite lost final column {c!r}: the optimized plan "
                    "never produces it",
                )
            )
        elif lv is not None and ov is not None and lv != ov:
            diags.append(
                Diagnostic(
                    "P013",
                    f"rewrite changed the value lineage of final column "
                    f"{c!r}: it would hold different bytes after the "
                    "optimized plan",
                )
            )
    return diags


def verify_plan_rewrites(
    frame_nodes: Sequence[P.PlanNode], final_schema: Sequence[str] = ()
) -> list[Diagnostic]:
    """Optimize ``frame_nodes`` and statically verify the rewrite. A crash
    inside the verifier itself degrades to a warning diagnostic — the
    verifier must never be the thing that blocks a valid plan. Copy of
    ``repro/analysis/rewrites.py:285``."""
    try:
        optimized = P.optimize_plan(list(frame_nodes), final_schema)
        return verify_rewrite_pair(frame_nodes, optimized, final_schema)
    except Exception as exc:  # noqa: BLE001 - degrade, never crash validate
        return [
            Diagnostic(
                "P011",
                f"rewrite verifier failed to analyze this plan: {exc!r}",
                severity="warning",
            )
        ]
