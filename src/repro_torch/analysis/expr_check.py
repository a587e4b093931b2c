"""Expression type checker: predicate against transform position,
build-time regex compilation, fingerprintability.

Copy of ``repro/analysis/expr_check.py`` (the whole file), over the
port's expressions and op descriptors (:mod:`repro_torch.core.expr`,
:mod:`repro_torch.core.bytesops`). Codes:

* ``E001``: transform position needs a string expression
* ``E002``: predicate position needs a predicate
* ``E003``: regex op does not compile
* ``E004`` (warning): unfingerprintable op (lambda word predicate)
* ``E005``: expression reads a column the schema does not hold
"""

from __future__ import annotations

import re

from ..core import bytesops as B
from ..core import expr as E
from .diagnostics import Diagnostic


def _check_expr_body(
    what: str, e: E.Expr, columns: dict[str, str], ref: tuple[str, ...]
) -> list[Diagnostic]:
    """Checks shared by both positions: column reads, op validity.
    Copy of ``repro/analysis/expr_check.py:32``."""
    diags: list[Diagnostic] = []
    unknown = sorted(n for n in e.inputs() if n not in columns)
    if unknown:
        diags.append(
            Diagnostic(
                "E005",
                f"{what} reads unknown column(s) {unknown}; "
                f"columns here are {sorted(columns)}",
                provenance=ref,
            )
        )
    for node in E.walk_exprs(e):
        if not isinstance(node, E.StrOp):
            continue
        op = node.op
        if op.kind == "regex" and op.regex is not None:
            try:
                re.compile(op.regex[0])
            except re.error as exc:
                diags.append(
                    Diagnostic(
                        "E003",
                        f"{what}: regex op {op.regex[0]!r} does not compile: {exc}",
                        provenance=ref,
                    )
                )
        try:
            B.op_signature(op)
        except B.UnfingerprintableOpError:
            diags.append(
                Diagnostic(
                    "E004",
                    f"{what}: op {node.label} is unfingerprintable (lambda "
                    "word predicate?) — it cannot cache and is invisible to "
                    "CSE; use a module-level function or functools.partial",
                    severity="warning",
                    provenance=ref,
                )
            )
    return diags


def check_transform(
    out_col: str, e, columns: dict[str, str], ref: tuple[str, ...]
) -> list[Diagnostic]:
    """Type-check one ``Project`` entry (transform position).
    Copy of ``repro/analysis/expr_check.py:78``."""
    what = f"Project entry {out_col!r}"
    if isinstance(e, E.Pred):
        return [
            Diagnostic(
                "E001",
                f"{what} needs a string expression, got the predicate "
                f"{e.describe()}; predicates belong in .where(...)",
                provenance=ref,
            )
        ]
    if isinstance(e, E.WordCount):
        return [
            Diagnostic(
                "E001",
                f"{what} needs a string expression, got {e.describe()} "
                "(an integer-valued count, not a column transform)",
                provenance=ref,
            )
        ]
    if not isinstance(e, E.Expr):
        return [
            Diagnostic(
                "E001",
                f"{what} needs a string expression, got {e!r}",
                provenance=ref,
            )
        ]
    return _check_expr_body(what, e, columns, ref)


def check_predicate(
    pred, columns: dict[str, str], ref: tuple[str, ...]
) -> list[Diagnostic]:
    """Type-check one ``Filter`` node's predicate (predicate position).
    Copy of ``repro/analysis/expr_check.py:112``."""
    if isinstance(pred, E.WordCount):
        return [
            Diagnostic(
                "E002",
                f"Filter needs a predicate, got {pred.describe()}; compare "
                "word_count() to an int (e.g. >= 5) to form one",
                provenance=ref,
            )
        ]
    if isinstance(pred, E.Expr):
        return [
            Diagnostic(
                "E002",
                f"Filter needs a predicate, got the string expression "
                f"{pred.describe()}; string transforms belong in a Project",
                provenance=ref,
            )
        ]
    if not isinstance(pred, E.Pred):
        return [
            Diagnostic(
                "E002", f"Filter needs a predicate, got {pred!r}", provenance=ref
            )
        ]
    diags: list[Diagnostic] = []
    for e in E.pred_exprs(pred):
        diags += _check_expr_body(f"Filter({pred.describe()})", e, columns, ref)
    return diags
