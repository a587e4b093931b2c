"""Host byte operations of the cleaning chains, on flat row buffers.

Copies of what the serving chains and the ``col()`` chains of
``repro_torch.core.expr`` need from ``repro/core/bytesops.py``: a column of
``n`` strings is one uint8 array whose rows each end in ``ROW_SEP``
(``\\x00``). The serving chains run the scan pass (lowercase and the two
span strips) on the device instead; see
``repro_torch.kernels.text_clean.ops.scan_flat``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

ROW_SEP = 0
SPACE = 32


def flatten(rows: Sequence[str]) -> np.ndarray:
    """Join rows with ROW_SEP into one uint8 buffer (trailing sep included).
    Copy of ``repro/core/bytesops.py:86 flatten``."""
    joined = ("\x00".join(rows) + "\x00").encode("utf-8", errors="ignore") if len(rows) else b""
    return np.frombuffer(joined, dtype=np.uint8).copy()


def unflatten(buf: np.ndarray) -> list[str]:
    """Inverse of :func:`flatten`. Copy of ``repro/core/bytesops.py:92``."""
    if buf.size == 0:
        return []
    parts = buf.tobytes().split(b"\x00")
    if parts and parts[-1] == b"":
        parts = parts[:-1]
    return [p.decode("utf-8", errors="ignore") for p in parts]


# ConvertToLower. Copy of ``repro/core/bytesops.py:110 LOWER_LUT``.
LOWER_LUT = np.arange(256, dtype=np.uint8)
LOWER_LUT[ord("A") : ord("Z") + 1] += 32

# RemoveUnwantedCharacters: keep [a-z], space, ROW_SEP; everything else
# (digits, punctuation, specials, residual uppercase, UTF-8 >127) -> space.
# Copy of ``repro/core/bytesops.py:115 UNWANTED_LUT``.
UNWANTED_LUT = np.full(256, SPACE, dtype=np.uint8)
UNWANTED_LUT[ord("a") : ord("z") + 1] = np.arange(ord("a"), ord("z") + 1, dtype=np.uint8)
UNWANTED_LUT[SPACE] = SPACE
UNWANTED_LUT[ROW_SEP] = ROW_SEP


# Contraction mapping, applied in this order after lowercasing and before
# punctuation stripping. Copy of ``repro/core/bytesops.py:123 CONTRACTIONS``.
CONTRACTIONS: tuple[tuple[bytes, bytes], ...] = (
    (b"won't", b"will not"),
    (b"can't", b"can not"),
    (b"shan't", b"shall not"),
    (b"n't", b" not"),
    (b"'re", b" are"),
    (b"'ve", b" have"),
    (b"'ll", b" will"),
    (b"'m", b" am"),
    (b"'d", b" would"),
    (b"'s", b""),
    (b"'", b""),
)


def apply_lut(buf: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:143 apply_lut``."""
    return lut[buf]


def span_strip(buf: np.ndarray, open_b: int, close_b: int) -> np.ndarray:
    """Delete ``open .. close`` spans (both delimiters included), depth
    reset at every row separator. Copy of ``repro/core/bytesops.py:147``."""
    opens = buf == open_b
    closes = buf == close_b
    delta = np.subtract(opens, closes, dtype=np.int8)
    depth = np.cumsum(delta, dtype=np.int32)
    sep = buf == ROW_SEP
    sep_depths = depth[sep]
    if sep_depths.size and sep_depths.any():  # malformed rows: per-row reset
        row_id = np.cumsum(sep, dtype=np.int32) - sep
        start_depth = np.concatenate(([0], sep_depths)).astype(np.int32)[row_id]
        inside = (depth - start_depth) > 0
    else:
        inside = depth > 0  # includes opener, excludes closer
    keep = ~(inside | closes) | sep
    return buf[keep]


def replace_patterns(buf: np.ndarray, patterns: Sequence[tuple[bytes, bytes]]) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:168 replace_patterns``."""
    raw = buf.tobytes()
    for pat, rep in patterns:
        raw = raw.replace(pat, rep)
    return np.frombuffer(raw, dtype=np.uint8).copy()


def collapse_spaces(buf: np.ndarray) -> np.ndarray:
    """Collapse space runs; strip leading/trailing spaces of each row.
    Copy of ``repro/core/bytesops.py:179 collapse_spaces``."""
    if buf.size == 0:
        return buf
    sp = buf == SPACE
    sep = buf == ROW_SEP
    prev_sp_or_start = np.empty_like(sp)
    prev_sp_or_start[0] = True
    prev_sp_or_start[1:] = sp[:-1] | sep[:-1]
    buf2 = buf[~(sp & prev_sp_or_start)]
    sp2 = buf2 == SPACE
    next_sep = np.empty_like(sp2)
    next_sep[-1] = True
    next_sep[:-1] = buf2[1:] == ROW_SEP
    return buf2[~(sp2 & next_sep)]


def remove_words(buf: np.ndarray, drop: Callable[[bytes], bool]) -> np.ndarray:
    """Delete the space-delimited words for which ``drop(word)`` is true,
    then collapse spaces: the semantics of ``repro/core/bytesops.py:396
    remove_words`` (words are maximal runs of bytes other than space and
    ROW_SEP; word-level stages always collapse)."""
    if buf.size == 0:
        return buf
    rows = buf.tobytes().split(b"\x00")[:-1]
    out = b"".join(
        b" ".join(w for w in row.split(b" ") if w and not drop(w)) + b"\x00" for row in rows
    )
    return np.frombuffer(out, dtype=np.uint8).copy()


def remove_short_words(buf: np.ndarray, threshold: int) -> np.ndarray:
    """Drop words of at most ``threshold`` bytes (``bytesops.py:418``)."""
    return remove_words(buf, lambda w: len(w) <= threshold)


def remove_stopwords(buf: np.ndarray, stopwords: frozenset[bytes]) -> np.ndarray:
    """Drop words in ``stopwords`` (``bytesops.py:422``; a byte-word set
    matches exactly what the reference's packed ``WordSet`` matches)."""
    return remove_words(buf, stopwords.__contains__)


# ---------------------------------------------------------------------------
# Op descriptors: the compiled form of a col() chain
# (``repro/core/bytesops.py:432-521``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Op:
    """One byte op of a compiled chain. Copy of ``repro/core/bytesops.py:432
    Op`` without its regex kind; ``pred`` takes one word's bytes (the
    reference's takes a packed ``WordView`` of all words at once)."""

    kind: str  # "lut" | "span" | "replace" | "collapse" | "wordpred"
    lut: np.ndarray | None = None
    span: tuple[int, int] | None = None
    patterns: tuple[tuple[bytes, bytes], ...] | None = None
    pred: Callable[[bytes], bool] | None = None


# Module-level predicates (picklable, as the reference's are).


def pred_short(word: bytes, threshold: int) -> bool:
    return len(word) <= threshold


def pred_stopword(word: bytes, words: frozenset[bytes]) -> bool:
    return word in words


def lut_op(lut: np.ndarray) -> Op:
    return Op("lut", lut=lut)


def span_op(open_c: str, close_c: str) -> Op:
    return Op("span", span=(ord(open_c), ord(close_c)))


def replace_op(patterns: Sequence[tuple[bytes, bytes]]) -> Op:
    return Op("replace", patterns=tuple(patterns))


def collapse_op() -> Op:
    return Op("collapse")


def wordpred_op(pred: Callable[[bytes], bool]) -> Op:
    return Op("wordpred", pred=pred)


def apply_op(buf: np.ndarray, op: Op) -> np.ndarray:
    if op.kind == "lut":
        return apply_lut(buf, op.lut)
    if op.kind == "span":
        return span_strip(buf, *op.span)
    if op.kind == "replace":
        return replace_patterns(buf, op.patterns)
    if op.kind == "collapse":
        return collapse_spaces(buf)
    if op.kind == "wordpred":
        return remove_words(buf, op.pred)
    raise ValueError(f"unknown op {op.kind}")


def apply_ops(buf: np.ndarray, ops: Sequence[Op]) -> np.ndarray:
    for op in ops:
        buf = apply_op(buf, op)
    return buf
