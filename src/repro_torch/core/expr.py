"""Per-column ``col()`` chains: the expression subset ``DeviceCleaner`` runs.

Copy of the per-column string chain of ``repro/core/expr.py``: ``Expr``
(``:68``), ``Col`` (``:179``), ``StrOp`` (``:211``), ``col`` (``:251``),
the string verbs (``:89-162``) and ``compile_expr`` (``:560``) for the
``("chain", column, ops)`` form. An expression is a description; compiling
it gives the op tuple that ``bytesops.apply_ops`` runs over a flat buffer.

Not copied yet: literals, ``concat``, predicates, ``regex_replace`` and
signatures, which the planner needs (ROADMAP Queue 1, the ``Dataset``
planner). ``remove_stopwords`` takes a set of byte words where the
reference packs a ``WordSet``; both match exactly the same words.
``remove_words`` takes a predicate of one word's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

from . import bytesops as B

# Copy of ``repro/core/expr.py:42 ENGLISH_STOPWORDS``.
ENGLISH_STOPWORDS: tuple[str, ...] = tuple(
    (
        "i me my myself we our ours ourselves you your yours yourself yourselves "
        "he him his himself she her hers herself it its itself they them their "
        "theirs themselves what which who whom this that these those am is are "
        "was were be been being have has had having do does did doing a an the "
        "and but if or because as until while of at by for with about against "
        "between into through during before after above below to from up down in "
        "out on off over under again further then once here there when where why "
        "how all any both each few more most other some such no nor not only own "
        "same so than too very s t can will just don should now"
    ).split()
)
STOPSET = frozenset(w.encode() for w in ENGLISH_STOPWORDS)


class Expr:
    """Base string expression: one text column's worth of rows."""

    def inputs(self) -> set[str]:
        """Free source columns this expression reads."""
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - convenience
        return self.describe()

    # -- string ops (each appends one vectorized byte op) -------------------
    def _op(self, op: B.Op, label: str) -> "Expr":
        return StrOp(self, op, label)

    def lower(self) -> "Expr":
        """ASCII lowercase (one 256-entry LUT pass)."""
        return self._op(B.lut_op(B.LOWER_LUT), "lower()")

    def strip_html(self) -> "Expr":
        """Delete ``<...>`` spans (balanced per row)."""
        return self._op(B.span_op("<", ">"), "strip_html()")

    def strip_parens(self) -> "Expr":
        """Delete ``(...)`` spans (balanced per row)."""
        return self._op(B.span_op("(", ")"), "strip_parens()")

    def expand_contractions(self) -> "Expr":
        """Map English contractions (``won't`` -> ``will not``, ...)."""
        return self._op(B.replace_op(B.CONTRACTIONS), "expand_contractions()")

    def keep_letters(self) -> "Expr":
        """Replace everything outside ``[a-z ]`` with a space."""
        return self._op(B.lut_op(B.UNWANTED_LUT), "keep_letters()")

    def collapse_spaces(self) -> "Expr":
        """Collapse space runs; strip leading/trailing spaces per row."""
        return self._op(B.collapse_op(), "collapse_spaces()")

    def replace(self, patterns: Sequence[tuple[str, str]]) -> "Expr":
        """Literal byte replacements, one pass per pattern."""
        for p, r in patterns:
            if "\x00" in p or "\x00" in r:
                raise ValueError(
                    "replace() patterns must not match or emit NUL (the row separator)"
                )
        pats = tuple((p.encode(), r.encode()) for p, r in patterns)
        return self._op(B.replace_op(pats), f"replace({len(pats)} patterns)")

    def remove_stopwords(
        self, stopwords: Sequence[str] | frozenset[bytes] | None = None
    ) -> "Expr":
        """Drop dictionary words (default: the English stopword core). A
        frozenset is taken as the byte words themselves, as the reference
        takes a built ``WordSet``."""
        if stopwords is None:
            words = STOPSET
        elif isinstance(stopwords, frozenset):
            words = stopwords
        else:
            words = frozenset(w.encode() for w in stopwords)
        return self._op(B.wordpred_op(partial(B.pred_stopword, words=words)),
                        f"remove_stopwords({len(words)} words)")

    def min_word_len(self, n: int) -> "Expr":
        """Keep only words of at least ``n`` bytes."""
        return self._op(B.wordpred_op(partial(B.pred_short, threshold=int(n) - 1)),
                        f"min_word_len({int(n)})")

    def remove_words(self, pred: Callable[[bytes], bool]) -> "Expr":
        """Drop the words (as bytes) for which ``pred`` is true."""
        return self._op(B.wordpred_op(pred),
                        f"remove_words({getattr(pred, '__qualname__', repr(pred))})")


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def inputs(self) -> set[str]:
        return {self.name}

    def describe(self) -> str:
        return f"col({self.name!r})"


@dataclass(frozen=True, eq=False)
class StrOp(Expr):
    input: Expr
    op: B.Op
    label: str

    def inputs(self) -> set[str]:
        return self.input.inputs()

    def describe(self) -> str:
        return f"{self.input.describe()}.{self.label}"


def col(name: str) -> Col:
    """Reference a source (or previously derived) column."""
    return Col(name)


def compile_expr(e: Expr) -> tuple:
    """``("chain", column, (op, ...))`` for a chain of string ops over one
    column; ``TypeError`` for any other root, as the reference raises for
    roots it cannot compile."""
    ops: list[B.Op] = []
    node = e
    while isinstance(node, StrOp):
        ops.append(node.op)
        node = node.input
    ops.reverse()
    if isinstance(node, Col):
        return ("chain", node.name, tuple(ops))
    raise TypeError(f"cannot compile expression root {node!r}")
