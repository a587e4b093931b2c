"""The case study's cleaning chains (paper Figs. 2 and 3) for serving.

Counterparts of ``repro/core/expr.py:524-543`` (``clean_text``,
``abstract_expr``, ``title_expr``) preceded by ingestion's NUL
normalisation (``repro/core/ingest.py:33 _normalize``). Byte for byte:

1. NUL -> space;
2. the scan pass on the device: lowercase, ``<...>`` span, ``(...)`` span;
3. on the host: contractions, ``keep_letters``, collapse, stopwords
   (abstracts only) and ``min_word_len(2)``.
"""

from __future__ import annotations

from typing import Sequence

from ..kernels.text_clean.ops import scan_flat
from . import bytesops as B
from .expr import STOPSET

_SHORT = 1  # min_word_len(2): words of at most one byte go


def _clean(rows: Sequence[str], device, *, stopwords: bool) -> list[str]:
    buf = B.flatten([r.replace("\x00", " ") for r in rows])
    buf = scan_flat(buf, lower=True, strip_html=True, strip_parens=True, device=device)
    buf = B.replace_patterns(buf, B.CONTRACTIONS)
    buf = B.collapse_spaces(B.UNWANTED_LUT[buf])
    if stopwords:
        buf = B.remove_stopwords(buf, STOPSET)
    buf = B.remove_short_words(buf, _SHORT)
    return B.unflatten(buf)


def clean_abstracts(rows: Sequence[str], device=None) -> list[str]:
    """``abstract_expr()``: full cleaning, stopwords removed."""
    return _clean(rows, device, stopwords=True)


def clean_titles(rows: Sequence[str], device=None) -> list[str]:
    """``title_expr()``: full cleaning, stopwords kept."""
    return _clean(rows, device, stopwords=False)
