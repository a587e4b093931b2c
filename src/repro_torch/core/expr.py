"""Column-expression IR: the composable algebra behind the ``Dataset`` verbs.

Copy of ``repro/core/expr.py`` (the whole file). ``col("abstract")`` /
``lit("x")`` / ``concat(...)`` build string expressions whose chained
methods (``.lower()``, ``.strip_html()``, ``.regex_replace()``,
``.remove_stopwords()``, ``.min_word_len(n)``, ...) append byte ops of
:mod:`repro_torch.core.bytesops`; ``.word_count() >= n``,
``.contains("x")``, ``.not_empty()`` and ``& | ~`` build predicates that
evaluate to row masks straight off the flat buffers. Every node has a
structural signature (stable across rebuilds, sensitive to every
parameter); ``describe()`` renders as the reference's does, so the port's
``explain()`` prints the reference's plans. :func:`compile_expr` /
:func:`compile_pred` lower expressions to plain tuples over op descriptors
that the whole-frame executor and the shard executor's threads run.

Where the port differs: ``remove_stopwords`` takes a set of byte words
where the reference packs a ``WordSet`` (both match exactly the same
words), ``remove_words`` takes a predicate of one word's bytes, and
:func:`eval_str` / :func:`eval_mask` take the ``device`` on which the
``device`` backend's scan passes run.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Sequence

import numpy as np

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


def _len_prefixed(parts: Sequence[bytes]) -> bytes:
    """Copy of ``repro/core/expr.py:59``."""
    return b"".join(len(p).to_bytes(8, "little") + p for p in parts)


# ---------------------------------------------------------------------------
# String expressions
# ---------------------------------------------------------------------------


class Expr:
    """Base string expression: one text column's worth of rows.
    Copy of ``repro/core/expr.py:68``."""

    # -- structural identity ------------------------------------------------
    def signature(self) -> bytes:
        raise NotImplementedError

    def fingerprint(self) -> str:
        return hashlib.blake2b(self.signature(), digest_size=16).hexdigest()

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
        """Map English contractions (``won't`` → ``will not``, …)."""
        return self._op(B.replace_op(B.CONTRACTIONS), "expand_contractions()")

    def keep_letters(self) -> "Expr":
        """Replace everything outside ``[a-z ]`` with a space."""
        return self._op(B.lut_op(B.UNWANTED_LUT), "keep_letters()")

    def collapse_spaces(self) -> "Expr":
        """Collapse space runs; strip leading/trailing spaces per row."""
        return self._op(B.collapse_op(), "collapse_spaces()")

    def replace(self, patterns: Sequence[tuple[str, str]]) -> "Expr":
        """Literal byte replacements, one C-speed pass per pattern."""
        for p, r in patterns:
            if "\x00" in p or "\x00" in r:
                raise ValueError(
                    "replace() patterns must not match or emit NUL "
                    "(the row separator)"
                )
        pats = tuple((p.encode(), r.encode()) for p, r in patterns)
        return self._op(B.replace_op(pats), f"replace({len(pats)} patterns)")

    def regex_replace(self, pattern: str, repl: str = "") -> "Expr":
        """Regex substitution (byte-level; must not touch the row separator)."""
        return self._op(
            B.regex_op(pattern, repl), f"regex_replace({pattern!r}, {repl!r})"
        )

    def remove_stopwords(
        self, stopwords: Sequence[str] | frozenset[bytes] | None = None
    ) -> "Expr":
        """Drop dictionary words (default: the English stopword core). A
        frozenset is taken as the byte words themselves, as the reference
        takes a built ``WordSet``."""
        if stopwords is None:
            words, n = STOPSET, len(ENGLISH_STOPWORDS)
        elif isinstance(stopwords, frozenset):
            words, n = stopwords, len(stopwords)
        else:
            words = frozenset(w.encode() for w in stopwords)
            n = len(tuple(stopwords))
        return self._op(
            B.wordpred_op(partial(B.pred_stopword, words=words)),
            f"remove_stopwords({n} words)",
        )

    def min_word_len(self, n: int) -> "Expr":
        """Keep only words of at least ``n`` bytes."""
        return self._op(
            B.wordpred_op(partial(B.pred_short, threshold=int(n) - 1)),
            f"min_word_len({int(n)})",
        )

    def remove_words(self, pred: Callable[[bytes], bool]) -> "Expr":
        """Escape hatch: drop the words (as bytes) for which ``pred`` is
        true. Use a module-level function (optionally via
        ``functools.partial``) to keep the expression fingerprintable and
        cacheable."""
        return self._op(
            B.wordpred_op(pred),
            f"remove_words({getattr(pred, '__qualname__', repr(pred))})",
        )

    # -- predicates ---------------------------------------------------------
    def not_empty(self) -> "Pred":
        """True for rows with non-empty payload (the dropna predicate)."""
        return NotEmpty(self)

    def contains(self, needle: str) -> "Pred":
        """True for rows containing the literal ``needle``."""
        return Contains(self, needle)

    def word_count(self) -> "WordCount":
        """Per-row word count; compare it (``>= n`` …) to get a predicate."""
        return WordCount(self)


@dataclass(frozen=True)
class Col(Expr):
    """Copy of ``repro/core/expr.py:179``."""
    name: str

    def signature(self) -> bytes:
        return b"col:" + self.name.encode()

    def inputs(self) -> set[str]:
        return {self.name}

    def describe(self) -> str:
        return f"col({self.name!r})"


@dataclass(frozen=True)
class Lit(Expr):
    """Copy of ``repro/core/expr.py:193``."""
    value: str

    def __post_init__(self):
        if "\x00" in self.value:
            raise ValueError("lit() values must not include NUL (the row separator)")

    def signature(self) -> bytes:
        return b"lit:" + self.value.encode()

    def inputs(self) -> set[str]:
        return set()

    def describe(self) -> str:
        return f"lit({self.value!r})"


@dataclass(frozen=True, eq=False)
class StrOp(Expr):
    """Copy of ``repro/core/expr.py:211``."""
    input: Expr
    op: B.Op
    label: str

    def signature(self) -> bytes:
        return _len_prefixed([self.input.signature(), b"op:" + B.op_signature(self.op)])

    def inputs(self) -> set[str]:
        return self.input.inputs()

    def describe(self) -> str:
        return f"{self.input.describe()}.{self.label}"


@dataclass(frozen=True, eq=False)
class Concat(Expr):
    """Copy of ``repro/core/expr.py:227``."""
    parts: tuple[Expr, ...]
    sep: str = " "

    def __post_init__(self):
        if "\x00" in self.sep:
            raise ValueError("concat() sep must not include NUL (the row separator)")

    def signature(self) -> bytes:
        return b"concat:" + self.sep.encode() + b":" + _len_prefixed(
            [p.signature() for p in self.parts]
        )

    def inputs(self) -> set[str]:
        out: set[str] = set()
        for p in self.parts:
            out |= p.inputs()
        return out

    def describe(self) -> str:
        inner = ", ".join(p.describe() for p in self.parts)
        return f"concat({inner}, sep={self.sep!r})"


def col(name: str) -> Col:
    """Reference a source (or previously derived) column. Copy of ``repro/core/expr.py:251``."""
    return Col(name)


def lit(value: str) -> Lit:
    """A per-row constant (for use inside :func:`concat`). Copy of ``repro/core/expr.py:256``."""
    return Lit(str(value))


def concat(*parts: Expr | str, sep: str = " ") -> Concat:
    """Row-wise concatenation of expressions; plain strings become
    :func:`lit` constants. At least one part must read a column. Copy of
    ``repro/core/expr.py:261``."""
    exprs = tuple(p if isinstance(p, Expr) else Lit(str(p)) for p in parts)
    if not exprs:
        raise ValueError("concat() needs at least one part")
    if not any(e.inputs() for e in exprs):
        raise ValueError("concat() of literals only; reference at least one col()")
    return Concat(exprs, sep)


# ---------------------------------------------------------------------------
# Predicates (row masks)
# ---------------------------------------------------------------------------


class Pred:
    """Boolean row predicate over string expressions. Copy of ``repro/core/expr.py:277``."""

    def signature(self) -> bytes:
        raise NotImplementedError

    def fingerprint(self) -> str:
        return hashlib.blake2b(self.signature(), digest_size=16).hexdigest()

    def inputs(self) -> set[str]:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - convenience
        return self.describe()

    def __and__(self, other: "Pred") -> "Pred":
        return BoolOp("and", self, other)

    def __or__(self, other: "Pred") -> "Pred":
        return BoolOp("or", self, other)

    def __invert__(self) -> "Pred":
        return NotOp(self)


@dataclass(frozen=True, eq=False)
class NotEmpty(Pred):
    """Copy of ``repro/core/expr.py:306``."""
    input: Expr

    def signature(self) -> bytes:
        return b"notempty:" + self.input.signature()

    def inputs(self) -> set[str]:
        return self.input.inputs()

    def describe(self) -> str:
        return f"{self.input.describe()}.not_empty()"


@dataclass(frozen=True, eq=False)
class Contains(Pred):
    """Copy of ``repro/core/expr.py:320``."""
    input: Expr
    needle: str

    def __post_init__(self):
        if "\x00" in self.needle:
            raise ValueError("contains() needle must not include NUL")

    def signature(self) -> bytes:
        return b"contains:" + self.needle.encode() + b":" + self.input.signature()

    def inputs(self) -> set[str]:
        return self.input.inputs()

    def describe(self) -> str:
        return f"{self.input.describe()}.contains({self.needle!r})"


@dataclass(frozen=True, eq=False)
class WordCount:
    """Per-row word count of a string expression. Not itself a predicate —
    compare it against an int to get one. Copy of
    ``repro/core/expr.py:339``."""

    input: Expr

    def describe(self) -> str:
        return f"{self.input.describe()}.word_count()"

    def _cmp(self, op: str, n: Any) -> "Compare":
        if not isinstance(n, (int, np.integer)):
            raise TypeError(f"word_count() compares against an int, got {n!r}")
        return Compare(self, op, int(n))

    def __ge__(self, n): return self._cmp(">=", n)
    def __gt__(self, n): return self._cmp(">", n)
    def __le__(self, n): return self._cmp("<=", n)
    def __lt__(self, n): return self._cmp("<", n)
    def __eq__(self, n): return self._cmp("==", n)  # type: ignore[override]
    def __ne__(self, n): return self._cmp("!=", n)  # type: ignore[override]


_CMP_FNS = {
    ">=": np.greater_equal,
    ">": np.greater,
    "<=": np.less_equal,
    "<": np.less,
    "==": np.equal,
    "!=": np.not_equal,
}


@dataclass(frozen=True, eq=False)
class Compare(Pred):
    """Copy of ``repro/core/expr.py:372``."""
    left: WordCount
    op: str
    right: int

    def signature(self) -> bytes:
        return (
            b"wc" + self.op.encode() + str(self.right).encode()
            + b":" + self.left.input.signature()
        )

    def inputs(self) -> set[str]:
        return self.left.input.inputs()

    def describe(self) -> str:
        return f"({self.left.describe()} {self.op} {self.right})"


@dataclass(frozen=True, eq=False)
class BoolOp(Pred):
    """Copy of ``repro/core/expr.py:391``."""
    kind: str  # "and" | "or"
    left: Pred
    right: Pred

    def signature(self) -> bytes:
        return self.kind.encode() + b":" + _len_prefixed(
            [self.left.signature(), self.right.signature()]
        )

    def inputs(self) -> set[str]:
        return self.left.inputs() | self.right.inputs()

    def describe(self) -> str:
        sym = "&" if self.kind == "and" else "|"
        return f"({self.left.describe()} {sym} {self.right.describe()})"


@dataclass(frozen=True, eq=False)
class NotOp(Pred):
    """Copy of ``repro/core/expr.py:410``."""
    input: Pred

    def signature(self) -> bytes:
        return b"not:" + self.input.signature()

    def inputs(self) -> set[str]:
        return self.input.inputs()

    def describe(self) -> str:
        return f"~{self.input.describe()}"


# ---------------------------------------------------------------------------
# Plan-level rewriting support (CSE + conjunct splitting; see core.plan)
# ---------------------------------------------------------------------------


def split_conjuncts(p: Pred) -> list[Pred]:
    """Flatten nested ``&`` into the ordered list of conjuncts.
    Copy of ``repro/core/expr.py:428``."""
    if isinstance(p, BoolOp) and p.kind == "and":
        return split_conjuncts(p.left) + split_conjuncts(p.right)
    return [p]


def and_all(preds: Sequence[Pred]) -> Pred:
    """Rebuild a conjunction left-associatively (inverse of
    :func:`split_conjuncts` up to grouping). Copy of
    ``repro/core/expr.py:435``."""
    out = preds[0]
    for p in preds[1:]:
        out = BoolOp("and", out, p)
    return out


def pred_exprs(p: Pred) -> list[Expr]:
    """The string expressions a predicate evaluates (one per comparison
    leaf, in evaluation order). Copy of
    ``repro/core/expr.py:444``."""
    if isinstance(p, (NotEmpty, Contains)):
        return [p.input]
    if isinstance(p, Compare):
        return [p.left.input]
    if isinstance(p, (BoolOp,)):
        return pred_exprs(p.left) + pred_exprs(p.right)
    if isinstance(p, NotOp):
        return pred_exprs(p.input)
    raise TypeError(f"not a predicate: {p!r}")


def map_pred_exprs(p: Pred, fn: Callable[[Expr], Expr]) -> Pred:
    """Rebuild a predicate with ``fn`` applied to every string-expression
    leaf (used by the optimizer's CSE rewrite). Copy of
    ``repro/core/expr.py:458``."""
    if isinstance(p, NotEmpty):
        return NotEmpty(fn(p.input))
    if isinstance(p, Contains):
        return Contains(fn(p.input), p.needle)
    if isinstance(p, Compare):
        return Compare(WordCount(fn(p.left.input)), p.op, p.right)
    if isinstance(p, BoolOp):
        return BoolOp(p.kind, map_pred_exprs(p.left, fn), map_pred_exprs(p.right, fn))
    if isinstance(p, NotOp):
        return NotOp(map_pred_exprs(p.input, fn))
    raise TypeError(f"not a predicate: {p!r}")


def walk_exprs(e: Expr):
    """Yield every node of an expression tree, pre-order (root first).
    Copy of ``repro/core/expr.py:474``."""
    yield e
    if isinstance(e, StrOp):
        yield from walk_exprs(e.input)
    elif isinstance(e, Concat):
        for p in e.parts:
            yield from walk_exprs(p)


def resolved_signature(
    e: Expr, versions: dict[str, bytes | None]
) -> bytes | None:
    """Version-resolved structural signature: :meth:`Expr.signature` with
    every ``col()`` leaf replaced by the column's current *version token*
    (what the column holds at this point of a plan, not its name). Two
    sub-expressions with equal resolved signatures evaluate to the same
    bytes per surviving row wherever they sit in the plan — the soundness
    condition for common-subexpression elimination. ``None`` marks an
    unfingerprintable subtree (lambda word predicate, poisoned input
    version): never considered equal to anything. Copy of
    ``repro/core/expr.py:484``."""
    if isinstance(e, Col):
        v = versions.get(e.name, b"src:" + e.name.encode())
        return None if v is None else b"ver:" + v
    if isinstance(e, Lit):
        return e.signature()
    if isinstance(e, StrOp):
        base = resolved_signature(e.input, versions)
        if base is None:
            return None
        try:
            osig = B.op_signature(e.op)
        except B.UnfingerprintableOpError:
            return None
        return _len_prefixed([base, b"op:" + osig])
    if isinstance(e, Concat):
        parts = [resolved_signature(p, versions) for p in e.parts]
        if any(s is None for s in parts):
            return None
        return b"concat:" + e.sep.encode() + b":" + _len_prefixed(
            [s for s in parts if s is not None]
        )
    raise TypeError(f"cannot sign expression {e!r}")


# ---------------------------------------------------------------------------
# Canonical case-study expressions (paper Fig. 2 / Fig. 3, expression form)
# ---------------------------------------------------------------------------


def clean_text(e: Expr) -> Expr:
    """The paper's §4.1.1-§4.1.3 character cleanup as one chain.
    Copy of ``repro/core/expr.py:524``."""
    return (
        e.lower()
        .strip_html()
        .strip_parens()
        .expand_contractions()
        .keep_letters()
        .collapse_spaces()
    )


def abstract_expr(column: str = "abstract", threshold: int = 1) -> Expr:
    """Paper Fig. 2: abstracts are the model *feature* → full cleaning.
    Copy of ``repro/core/expr.py:536``."""
    return clean_text(col(column)).remove_stopwords().min_word_len(threshold + 1)


def title_expr(column: str = "title", threshold: int = 1) -> Expr:
    """Paper Fig. 3: titles are the model *target* → keep stopwords.
    Copy of ``repro/core/expr.py:541``."""
    return clean_text(col(column)).min_word_len(threshold + 1)


# ---------------------------------------------------------------------------
# Compilation: expressions → picklable flat-buffer programs
# ---------------------------------------------------------------------------
#
# Compiled string forms (plain tuples; Op descriptors are picklable):
#   ("chain", in_col, (op, ...))           ops applied to one column's buffer
#   ("concat", sep_bytes, (compiled, ...)) row-wise concat of parts
#   ("lit", value_str)                     per-row constant
# Compiled predicate forms:
#   ("nonempty", compiled) | ("wc", cmp, n, compiled)
#   | ("contains", needle_bytes, compiled)
#   | ("and", p, p) | ("or", p, p) | ("not", p)


def compile_expr(e: Expr) -> tuple:
    """Copy of ``repro/core/expr.py:560``."""
    ops: list[B.Op] = []
    node = e
    while isinstance(node, StrOp):
        ops.append(node.op)
        node = node.input
    ops.reverse()
    if isinstance(node, Col):
        return ("chain", node.name, tuple(ops))
    if isinstance(node, Lit):
        base: tuple = ("lit", node.value)
    elif isinstance(node, Concat):
        base = ("concat", node.sep.encode(), tuple(compile_expr(p) for p in node.parts))
    else:
        raise TypeError(f"cannot compile expression root {node!r}")
    if not ops:
        return base
    # ops over a concat/lit root: wrap as a chain with a non-column source
    return ("wrap", base, tuple(ops))


def compile_pred(p: Pred) -> tuple:
    """Copy of ``repro/core/expr.py:581``."""
    if isinstance(p, NotEmpty):
        return ("nonempty", compile_expr(p.input))
    if isinstance(p, Contains):
        return ("contains", p.needle.encode(), compile_expr(p.input))
    if isinstance(p, Compare):
        return ("wc", p.op, p.right, compile_expr(p.left.input))
    if isinstance(p, BoolOp):
        return (p.kind, compile_pred(p.left), compile_pred(p.right))
    if isinstance(p, NotOp):
        return ("not", compile_pred(p.input))
    raise TypeError(f"cannot compile predicate {p!r}")


def fuse_compiled(comp: tuple) -> tuple:
    """Catalyst-style op fusion inside a compiled expression (exact).
    Copy of ``repro/core/expr.py:595``."""
    kind = comp[0]
    if kind == "chain":
        return ("chain", comp[1], tuple(B.fuse_ops(list(comp[2]))))
    if kind == "wrap":
        return ("wrap", fuse_compiled(comp[1]), tuple(B.fuse_ops(list(comp[2]))))
    if kind == "concat":
        return ("concat", comp[1], tuple(fuse_compiled(c) for c in comp[2]))
    if kind == "nonempty":
        return ("nonempty", fuse_compiled(comp[1]))
    if kind == "contains":
        return ("contains", comp[1], fuse_compiled(comp[2]))
    if kind == "wc":
        return ("wc", comp[1], comp[2], fuse_compiled(comp[3]))
    if kind in ("and", "or"):
        return (kind, fuse_compiled(comp[1]), fuse_compiled(comp[2]))
    if kind == "not":
        return ("not", fuse_compiled(comp[1]))
    return comp


def compiled_inputs(comp: tuple) -> set[str]:
    """Copy of ``repro/core/expr.py:617``."""
    kind = comp[0]
    if kind == "chain":
        return {comp[1]}
    if kind == "lit":
        return set()
    if kind == "wrap":
        return compiled_inputs(comp[1])
    if kind == "concat":
        out: set[str] = set()
        for c in comp[2]:
            out |= compiled_inputs(c)
        return out
    # predicate forms
    if kind == "nonempty":
        return compiled_inputs(comp[1])
    if kind in ("contains",):
        return compiled_inputs(comp[2])
    if kind == "wc":
        return compiled_inputs(comp[3])
    if kind in ("and", "or"):
        return compiled_inputs(comp[1]) | compiled_inputs(comp[2])
    if kind == "not":
        return compiled_inputs(comp[1])
    raise ValueError(f"unknown compiled form {kind!r}")


def compiled_signature(comp: tuple) -> bytes:
    """Stable byte signature of a compiled expression/predicate — the unit
    the shard cache keys on. Raises
    :class:`~repro_torch.core.bytesops.UnfingerprintableOpError` for ops whose
    behavior cannot be captured (lambda predicates). Copy of
    ``repro/core/expr.py:644``."""
    kind = comp[0]
    if kind == "chain":
        return b"chain:" + comp[1].encode() + b":" + _len_prefixed(
            [B.op_signature(op) for op in comp[2]]
        )
    if kind == "lit":
        return b"lit:" + comp[1].encode()
    if kind == "wrap":
        return b"wrap:" + _len_prefixed(
            [compiled_signature(comp[1])] + [B.op_signature(op) for op in comp[2]]
        )
    if kind == "concat":
        return b"concat:" + comp[1] + b":" + _len_prefixed(
            [compiled_signature(c) for c in comp[2]]
        )
    if kind == "nonempty":
        return b"nonempty:" + compiled_signature(comp[1])
    if kind == "contains":
        return b"contains:" + comp[1] + b":" + compiled_signature(comp[2])
    if kind == "wc":
        return b"wc" + comp[1].encode() + str(comp[2]).encode() + b":" + compiled_signature(comp[3])
    if kind in ("and", "or"):
        return kind.encode() + b":" + _len_prefixed(
            [compiled_signature(comp[1]), compiled_signature(comp[2])]
        )
    if kind == "not":
        return b"not:" + compiled_signature(comp[1])
    raise ValueError(f"unknown compiled form {kind!r}")


# ---------------------------------------------------------------------------
# Evaluation over flat buffers
# ---------------------------------------------------------------------------


def eval_str(
    comp: tuple,
    lookup: Callable[[str], np.ndarray],
    n_rows: int,
    backend: str | None = None,
    device=None,
) -> np.ndarray:
    """Evaluate a compiled string expression to a flat byte buffer.
    ``lookup(col)`` returns the current flat buffer of a column;
    ``backend`` selects the bytesops backend for op chains (the same bytes
    under each), and ``device`` is where the ``device`` backend's scan
    passes run. Copy of
    ``repro/core/expr.py:684``."""
    kind = comp[0]
    if kind == "chain":
        return B.execute_ops(lookup(comp[1]), comp[2], backend, device)
    if kind == "lit":
        return B.flatten([comp[1]] * n_rows)
    if kind == "wrap":
        inner = eval_str(comp[1], lookup, n_rows, backend, device)
        return B.execute_ops(inner, comp[2], backend, device)
    if kind == "concat":
        parts = [eval_str(c, lookup, n_rows, backend, device) for c in comp[2]]
        return B.concat_rows(parts, comp[1])
    raise ValueError(f"unknown compiled form {kind!r}")


def eval_mask(
    comp: tuple,
    lookup: Callable[[str], np.ndarray],
    n_rows: int,
    backend: str | None = None,
    device=None,
) -> np.ndarray:
    """Evaluate a compiled predicate to a boolean row mask, straight off
    flat byte buffers: no row ever decodes. Copy of
    ``repro/core/expr.py:707``."""
    kind = comp[0]
    args = (lookup, n_rows, backend, device)
    if kind == "nonempty":
        return B.row_nonempty(eval_str(comp[1], *args))
    if kind == "contains":
        return B.rows_containing(eval_str(comp[2], *args), comp[1])
    if kind == "wc":
        counts = B.row_word_counts(eval_str(comp[3], *args))
        return _CMP_FNS[comp[1]](counts, comp[2])
    if kind == "and":
        return eval_mask(comp[1], *args) & eval_mask(comp[2], *args)
    if kind == "or":
        return eval_mask(comp[1], *args) | eval_mask(comp[2], *args)
    if kind == "not":
        return ~eval_mask(comp[1], *args)
    raise ValueError(f"unknown compiled form {kind!r}")


def compile_project(
    entries: Sequence[tuple[str, Expr]], optimize: bool
) -> tuple[tuple[str, tuple], ...]:
    """Compile a Project node's ``(out_col, expr)`` entries.

    Entries evaluate *sequentially* (entry k sees the columns entries < k
    wrote — Spark ``withColumn`` chaining). With ``optimize``, adjacent
    in-place chains over the same column merge into one op chain and every
    chain's ops are fused (exact, see ``bytesops.fuse_ops``); without it,
    each entry's ops run one by one (the paper-faithful executor).
    Copy of ``repro/core/expr.py:736``.
    """
    out: list[tuple[str, tuple]] = []
    for out_col, e in entries:
        comp = compile_expr(e)
        if (
            optimize
            and out
            and comp[0] == "chain"
            and comp[1] == out_col  # in-place over its own column
            and out[-1][0] == out_col
            and out[-1][1][0] == "chain"
        ):
            prev_col, prev = out[-1]
            out[-1] = (out_col, ("chain", prev[1], prev[2] + comp[2]))
        else:
            out.append((out_col, comp))
    if optimize:
        out = [(c, fuse_compiled(comp)) for c, comp in out]
    return tuple(out)
