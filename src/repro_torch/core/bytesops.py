"""Host byte operations of the cleaning chain, on flat row buffers.

Copies of what the abstract and title chains need from
``repro/core/bytesops.py``: a column of ``n`` strings is one uint8 array
whose rows each end in ``ROW_SEP`` (``\\x00``). The scan pass (lowercase
and the two span strips) runs on the device instead; see
``repro_torch.kernels.text_clean.ops.scan_flat``.
"""

from __future__ import annotations

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
