"""Spark ML Feature-style preprocessing stages (the paper's four new APIs).

Copy of ``repro/core/stages.py``: ``Stage`` (``:43``), the six stages
(``:85-182``), ``_strip_spans_row`` (``:96``), ``abstract_stages``
(``:185``) and ``title_stages`` (``:197``).

.. deprecated::
    As in the reference, the ``Stage`` verbs are shims over the column
    expressions of :mod:`repro_torch.core.expr`: a stage's behaviour is the
    expression its :meth:`Stage.to_expr` builds. They stay for the paper's
    API (``abstract_stages``/``title_stages``, ``run_p3sapp``) and as the
    row-wise oracle of the conventional approach.

Each stage follows the Spark ML ``Transformer`` protocol (``fit`` returns
the stage) and has two paths with the same semantics:

* ``to_expr`` / ``flat_ops`` / ``transform_flat``: byte ops over the flat
  column buffer (:mod:`repro_torch.core.bytesops`), the P3SAPP path;
* ``transform_row``: one row at a time, the conventional approach's path
  (Algorithm 2).

``StopWordsRemover`` holds a frozenset of byte words where the reference
packs a ``WordSet``; both match exactly the same words.
"""

from __future__ import annotations

import warnings

import numpy as np

from . import bytesops as B
from . import expr as E
from .expr import ENGLISH_STOPWORDS


class Stage:
    """Base transformer: the Spark ML Feature API protocol (a deprecated
    shim; behaviour is defined by :meth:`to_expr`)."""

    def __init__(self, input_col: str, output_col: str | None = None):
        warnings.warn(
            f"{type(self).__name__} is a deprecated shim over the column "
            "expression IR and will be removed; compose col() expressions "
            "instead (see repro_torch.core.expr)",
            DeprecationWarning,
            stacklevel=2,
        )
        self.input_col = input_col
        self.output_col = output_col or input_col

    # Spark Pipeline.fit() calls fit on estimators; transformers return
    # themselves.
    def fit(self, frame) -> "Stage":
        return self

    def to_expr(self, e: E.Expr) -> E.Expr:
        """The expression this stage is a shim for, applied to ``e``."""
        raise NotImplementedError

    def flat_ops(self) -> list[B.Op]:
        comp = E.compile_expr(self.to_expr(E.col(self.input_col)))
        assert comp[0] == "chain" and comp[1] == self.input_col
        return list(comp[2])

    def transform_flat(self, buf: np.ndarray) -> np.ndarray:
        return B.apply_ops(buf, self.flat_ops())

    def transform_row(self, row: str) -> str:
        raise NotImplementedError


_ASCII_LOWER_TABLE = {c: c + 32 for c in range(ord("A"), ord("Z") + 1)}


class ConvertToLower(Stage):
    """Paper §4.1.1: lowercase every entry of the column."""

    def to_expr(self, e):
        return e.lower()

    def transform_row(self, row):
        # ASCII-only lowering, as the byte LUT lowers.
        return row.translate(_ASCII_LOWER_TABLE)


def _strip_spans_row(row: str, open_c: str, close_c: str) -> str:
    out = []
    depth = 0
    for ch in row:
        if ch == open_c:
            depth += 1
        elif ch == close_c:
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


class RemoveHTMLTags(Stage):
    """Paper §4.1.2: strip ``<...>`` spans."""

    def to_expr(self, e):
        return e.strip_html()

    def transform_row(self, row):
        return _strip_spans_row(row, "<", ">")


class RemoveUnwantedCharacters(Stage):
    """Paper §4.1.3: parenthetical text, contraction mapping, punctuation,
    digits and special characters out; a lowercase word stream remains."""

    def to_expr(self, e):
        return e.strip_parens().expand_contractions().keep_letters().collapse_spaces()

    def transform_row(self, row):
        row = _strip_spans_row(row, "(", ")")
        for pat, rep in B.CONTRACTIONS:
            row = row.replace(pat.decode(), rep.decode())
        row = "".join(ch if ("a" <= ch <= "z" or ch == " ") else " " for ch in row)
        return " ".join(w for w in row.split(" ") if w)


class RemoveShortWords(Stage):
    """Paper §4.1.4: drop words with ``len(word) <= threshold``."""

    def __init__(self, input_col: str, output_col: str | None = None, threshold: int = 1):
        super().__init__(input_col, output_col)
        self.threshold = threshold

    def to_expr(self, e):
        return e.min_word_len(self.threshold + 1)

    def transform_row(self, row):
        return " ".join(w for w in row.split(" ") if len(w) > self.threshold)


class Tokenizer(Stage):
    """Spark ML ``Tokenizer``: whitespace split (in columnar form,
    whitespace normalised; the list is made at the frame's boundary)."""

    def to_expr(self, e):
        return e.collapse_spaces()

    def transform_row(self, row):
        return " ".join(w for w in row.split(" ") if w)


class StopWordsRemover(Stage):
    """Spark ML ``StopWordsRemover`` over a frozenset of byte words."""

    def __init__(
        self,
        input_col: str,
        output_col: str | None = None,
        stopwords: tuple[str, ...] = ENGLISH_STOPWORDS,
    ):
        super().__init__(input_col, output_col)
        self.stopwords = tuple(stopwords)
        self._stopset = frozenset(self.stopwords)
        self._words = frozenset(w.encode() for w in self.stopwords)

    def to_expr(self, e):
        return e.remove_stopwords(self._words)

    def transform_row(self, row):
        return " ".join(w for w in row.split(" ") if w and w not in self._stopset)


# ---------------------------------------------------------------------------
# The case study's workflows (paper Figs. 2 and 3)
# ---------------------------------------------------------------------------


def abstract_stages(col: str = "abstract", threshold: int = 1) -> list[Stage]:
    """Paper Fig. 2: abstracts are the model's feature, fully cleaned."""
    return [
        ConvertToLower(col),
        RemoveHTMLTags(col),
        RemoveUnwantedCharacters(col),
        StopWordsRemover(col),
        RemoveShortWords(col, threshold=threshold),
    ]


def title_stages(col: str = "title") -> list[Stage]:
    """Paper Fig. 3: titles are the model's target; stopwords stay."""
    return [
        ConvertToLower(col),
        RemoveHTMLTags(col),
        RemoveUnwantedCharacters(col),
        RemoveShortWords(col, threshold=1),
    ]
