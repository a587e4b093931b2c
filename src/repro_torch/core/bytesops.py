"""Host byte operations of the cleaning chains, on flat row buffers.

Copies of what the serving chains, the ``col()`` chains of
``repro_torch.core.expr`` and the stage pipeline need from
``repro/core/bytesops.py``, and what the ``Dataset`` planner's predicates,
``concat`` and fingerprints need: a column of ``n`` strings is one uint8
array whose rows each end in ``ROW_SEP`` (``\\x00``). The serving chains run the
scan pass (lowercase and the two span strips) on the device instead; see
``repro_torch.kernels.text_clean.ops.scan_flat``.

Backends (``repro/core/bytesops.py:660-672``, ``:982-1027``):
:func:`execute_ops` runs an op chain under ``loops`` (one pass per op),
``fused`` (the chain lowered by :func:`compile_megapass` to scan, word and
barrier passes, all on the host) or ``device``, the counterpart of the
reference's ``pallas``: the megapass with every scan pass that the
``text_scan`` kernel computes run on the card through ``scan_flat``. All
three give the same bytes. Selection: explicit argument >
``REPRO_BYTES_BACKEND`` > ``device``, since the port's entry points run on
the card unless the caller asks for the host.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import threading
from dataclasses import dataclass
from functools import partial
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


def n_rows(buf: np.ndarray) -> int:
    """Copy of ``repro/core/bytesops.py:102 n_rows``."""
    return int((buf == ROW_SEP).sum())


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


def regex_sub(buf: np.ndarray, pattern: bytes, repl: bytes) -> np.ndarray:
    """One compiled-regex substitution pass over the flat bytes, the row
    count re-verified: a match that crossed a separator would have to
    consume it. Copy of ``repro/core/bytesops.py:196 regex_sub``."""
    raw = buf.tobytes()
    out = re.sub(pattern, repl, raw)
    if out.count(b"\x00") != raw.count(b"\x00"):
        raise ValueError(
            f"regex_replace({pattern.decode(errors='replace')!r}) matched the "
            "row separator and would merge or split rows; exclude NUL from "
            "the pattern (e.g. use [^a-z\\x01-\\x1f] style classes)"
        )
    return np.frombuffer(out, dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Row-level reductions: predicates over flat buffers, no decode
# (``repro/core/bytesops.py:216-288``)
# ---------------------------------------------------------------------------


def row_lengths(buf: np.ndarray) -> np.ndarray:
    """Per-row byte length *including* the trailing separator. Copy of
    ``repro/core/bytesops.py:222 row_lengths``."""
    sep_idx = np.flatnonzero(buf == ROW_SEP)
    return np.diff(np.concatenate(([-1], sep_idx))).astype(np.int64)


def row_nonempty(buf: np.ndarray) -> np.ndarray:
    """Rows with at least one byte of payload. Copy of
    ``repro/core/bytesops.py:228 row_nonempty``."""
    return row_lengths(buf) > 1


def _segment_words(buf: np.ndarray):
    """(is_word_byte, word_id_per_byte, start_idx, lengths). Copy of
    ``repro/core/bytesops.py:288 _segment_words``."""
    delim = (buf == SPACE) | (buf == ROW_SEP)
    isw = ~delim
    starts = isw.copy()
    starts[1:] &= delim[:-1]
    start_idx = np.flatnonzero(starts)
    wid = np.cumsum(starts, dtype=np.int32) - 1  # valid where isw
    if start_idx.size:
        lengths = np.add.reduceat(isw.astype(np.int32), start_idx)
    else:
        lengths = np.zeros(0, dtype=np.int32)
    return isw, wid, start_idx, lengths


def row_word_counts(buf: np.ndarray) -> np.ndarray:
    """Per-row number of space-separated words. Copy of
    ``repro/core/bytesops.py:233 row_word_counts``."""
    n = n_rows(buf)
    counts = np.zeros(n, dtype=np.int64)
    if buf.size == 0:
        return counts
    sep = buf == ROW_SEP
    _, _, start_idx, _ = _segment_words(buf)
    if start_idx.size:
        row_of_byte = np.cumsum(sep, dtype=np.int64) - sep
        np.add.at(counts, row_of_byte[start_idx], 1)
    return counts


def rows_containing(buf: np.ndarray, needle: bytes) -> np.ndarray:
    """Rows whose payload contains the literal ``needle`` (without
    ``\\x00``, so a match never spans rows). Copy of
    ``repro/core/bytesops.py:247 rows_containing``."""
    n = n_rows(buf)
    mask = np.zeros(n, dtype=bool)
    if not needle or buf.size == 0:
        mask[:] = bool(n) and not needle
        return mask
    m = len(needle)
    if m > buf.size:
        return mask
    pat = np.frombuffer(needle, dtype=np.uint8)
    hit = buf[: buf.size - m + 1] == pat[0]
    for j in range(1, m):
        hit &= buf[j : buf.size - m + 1 + j] == pat[j]
    pos = np.flatnonzero(hit)
    if pos.size:
        sep = buf == ROW_SEP
        row_of_byte = np.cumsum(sep, dtype=np.int64) - sep
        mask[row_of_byte[pos]] = True
    return mask


def concat_rows(bufs: Sequence[np.ndarray], sep: bytes = b" ") -> np.ndarray:
    """Row-wise concatenation of equal-row-count flat buffers with ``sep``
    between the parts. Copy of ``repro/core/bytesops.py:270 concat_rows``."""
    if not bufs:
        raise ValueError("concat_rows needs at least one buffer")
    split = [b.tobytes().split(b"\x00")[:-1] for b in bufs]
    counts = {len(rows) for rows in split}
    if len(counts) > 1:
        raise ValueError(f"ragged concat inputs: row counts {sorted(counts)}")
    joined = b"".join(sep.join(parts) + b"\x00" for parts in zip(*split))
    return np.frombuffer(joined, dtype=np.uint8).copy()


def pack_word(word: str) -> tuple[int, int, int]:
    """(k1, k2, length) key of a word of at most 16 bytes, as
    ``data.batching.VocabTable`` packs it. Copy of
    ``repro/core/bytesops.py:343 pack_word``."""
    b = word.encode("utf-8")
    if len(b) > 16:
        raise ValueError(f"dictionary word too long: {word!r}")
    padded = b + b"\x00" * (16 - len(b))
    k = np.frombuffer(padded, dtype=np.uint64)
    return int(k[0]), int(k[1]), len(b)


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
    """Drop words of at most ``threshold`` bytes (``bytesops.py:418``).
    Copy of ``repro/core/bytesops.py:418``."""
    return remove_words(buf, lambda w: len(w) <= threshold)


def remove_stopwords(buf: np.ndarray, stopwords: frozenset[bytes]) -> np.ndarray:
    """Drop words in ``stopwords`` (``bytesops.py:422``; a byte-word set
    matches exactly what the reference's packed ``WordSet`` matches). Copy of
    ``repro/core/bytesops.py:422``."""
    return remove_words(buf, stopwords.__contains__)


# ---------------------------------------------------------------------------
# Op descriptors: the compiled form of a col() chain
# (``repro/core/bytesops.py:432-521``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Op:
    """One byte op of a compiled chain. Copy of ``repro/core/bytesops.py:432
    Op``; ``pred`` takes one word's bytes (the reference's takes a packed
    ``WordView`` of all words at once), so no op needs ``needs_hashes``."""

    kind: str  # "lut" | "span" | "replace" | "collapse" | "wordpred" | "regex"
    lut: np.ndarray | None = None
    span: tuple[int, int] | None = None
    patterns: tuple[tuple[bytes, bytes], ...] | None = None
    pred: Callable[[bytes], bool] | None = None
    regex: tuple[bytes, bytes] | None = None  # (pattern, repl)


# Module-level predicates (picklable, as the reference's are).


def pred_short(word: bytes, threshold: int) -> bool:
    """Copy of ``repro/core/bytesops.py:445``."""
    return len(word) <= threshold


def pred_stopword(word: bytes, words: frozenset[bytes]) -> bool:
    """Copy of ``repro/core/bytesops.py:449``."""
    return word in words


def pred_or(word: bytes, p1, p2) -> bool:
    """The OR of two word predicates, as fusion builds it.
    Copy of ``repro/core/bytesops.py:453``."""
    return p1(word) or p2(word)


def lut_op(lut: np.ndarray) -> Op:
    """Copy of ``repro/core/bytesops.py:457``."""
    return Op("lut", lut=lut)


def span_op(open_c: str, close_c: str) -> Op:
    """Copy of ``repro/core/bytesops.py:461``."""
    return Op("span", span=(ord(open_c), ord(close_c)))


def replace_op(patterns: Sequence[tuple[bytes, bytes]]) -> Op:
    """Copy of ``repro/core/bytesops.py:465``."""
    return Op("replace", patterns=tuple(patterns))


def collapse_op() -> Op:
    """Copy of ``repro/core/bytesops.py:469``."""
    return Op("collapse")


def wordpred_op(pred: Callable[[bytes], bool]) -> Op:
    """Copy of ``repro/core/bytesops.py:473``."""
    return Op("wordpred", pred=pred)


def regex_op(pattern: str, repl: str) -> Op:
    """Regex substitution op. The pattern must compile and must not match
    the row separator, and the replacement must not emit one; probed here,
    re-verified by :func:`regex_sub`. Copy of
    ``repro/core/bytesops.py:477 regex_op``."""
    pat = pattern.encode("utf-8")
    rep = repl.encode("utf-8")
    rx = re.compile(pat)  # fail fast on bad patterns, at plan-build time
    if b"\x00" in rep:
        raise ValueError("regex replacement must not emit NUL (the row separator)")
    for probe in (b"\x00", b"a\x00", b"\x00a", b"ab\x00cd"):
        if any(b"\x00" in m.group() for m in rx.finditer(probe)):
            raise ValueError(
                f"regex pattern {pattern!r} can match NUL (the row separator) "
                "and would merge or split rows; exclude \\x00 explicitly"
            )
    return Op("regex", regex=(pat, rep))


def apply_op(buf: np.ndarray, op: Op) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:501``."""
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
    if op.kind == "regex":
        return regex_sub(buf, *op.regex)
    raise ValueError(f"unknown op {op.kind}")


def apply_ops(buf: np.ndarray, ops: Sequence[Op]) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:517``."""
    for op in ops:
        buf = apply_op(buf, op)
    return buf


# ---------------------------------------------------------------------------
# Signatures: the unit of plan and cache fingerprints
# (``repro/core/bytesops.py:523-633``)
# ---------------------------------------------------------------------------


class UnfingerprintableOpError(ValueError):
    """The op's behavior cannot be captured in a stable signature (a
    lambda or a closure): its outputs are never cached. Copy of
    ``repro/core/bytesops.py:523``."""


def _pred_signature(pred) -> bytes:
    """Stable signature of a word predicate: a module-level function (its
    qualified name and bytecode) or a ``functools.partial`` tree over
    them, with every bound parameter. Copy of
    ``repro/core/bytesops.py:529 _pred_signature``."""
    if isinstance(pred, functools.partial):
        parts = [b"partial:", _pred_signature(pred.func)]
        for a in pred.args:
            parts.append(_value_signature(a))
        for k in sorted(pred.keywords):
            parts.append(k.encode() + b"=" + _value_signature(pred.keywords[k]))
        return b"|".join(parts)
    qualname = getattr(pred, "__qualname__", None)
    if qualname is None or "<lambda>" in qualname or "<locals>" in qualname:
        raise UnfingerprintableOpError(
            f"cannot fingerprint predicate {pred!r}; use a module-level "
            "function (optionally via functools.partial) to make it cacheable"
        )
    module = getattr(pred, "__module__", "") or ""
    parts = [f"{module}.{qualname}".encode()]
    code = getattr(pred, "__code__", None)
    if code is not None:
        parts.append(code.co_code)
        parts.append(
            repr([c for c in code.co_consts if not hasattr(c, "co_code")]).encode()
        )
    return b"\x1f".join(parts)


def _value_signature(value) -> bytes:
    """Deterministic signature of a predicate parameter; a set of stop
    words (the port's form of the reference's ``WordSet``) signs as its
    sorted members, so the signature is the same in every process. Copy of
    ``repro/core/bytesops.py:563 _value_signature``."""
    if callable(value):
        return _pred_signature(value)
    if isinstance(value, np.ndarray):
        return b"nd:" + value.tobytes()
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return f"{type(value).__name__}:{value!r}".encode()
    if isinstance(value, (tuple, list)):
        return b"seq:" + b",".join(_value_signature(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return b"set:" + b",".join(sorted(_value_signature(v) for v in value))
    if isinstance(value, dict):
        return b"map:" + b",".join(
            _value_signature(k) + b"=" + _value_signature(v)
            for k, v in sorted(value.items(), key=lambda kv: repr(kv[0]))
        )
    raise UnfingerprintableOpError(
        f"cannot fingerprint predicate parameter {value!r} "
        f"({type(value).__name__}); pass plain data or a set of byte words"
    )


def op_signature(op: Op) -> bytes:
    """Stable byte signature of one op. Copy of
    ``repro/core/bytesops.py:594 op_signature``."""
    if op.kind == "lut":
        return b"lut:" + op.lut.tobytes()
    if op.kind == "span":
        return b"span:%d,%d" % op.span
    if op.kind == "replace":
        # Length-prefixed, so two pattern lists never collide.
        parts = [b"replace:"]
        for p, r in op.patterns:
            parts.append(len(p).to_bytes(4, "little") + p)
            parts.append(len(r).to_bytes(4, "little") + r)
        return b"".join(parts)
    if op.kind == "collapse":
        return b"collapse"
    if op.kind == "wordpred":
        return b"wordpred:" + _pred_signature(op.pred)
    if op.kind == "regex":
        pat, rep = op.regex
        return (
            b"regex:"
            + len(pat).to_bytes(4, "little") + pat
            + len(rep).to_bytes(4, "little") + rep
        )
    raise ValueError(f"unknown op {op.kind}")


# Every fingerprint of the port's planner and cache starts with this tag,
# so no fingerprint of the port coincides with one of the JAX package.
PORT_TAG = b"repro_torch\x1f"


def ops_fingerprint(ops: Sequence[Op]) -> str:
    """Hex fingerprint of an op chain (order-sensitive, parameter-exact),
    port-tagged. Copy of ``repro/core/bytesops.py:623 ops_fingerprint``."""
    h = hashlib.blake2b(PORT_TAG, digest_size=16)
    for op in ops:
        sig = op_signature(op)
        h.update(len(sig).to_bytes(8, "little"))
        h.update(sig)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Fusion and the megapass (``repro/core/bytesops.py:635-1027``)
# ---------------------------------------------------------------------------


def fuse_ops(ops: Sequence[Op]) -> list[Op]:
    """Adjacent-op fusion: LUT o LUT composes, adjacent collapses dedupe,
    adjacent word predicates OR into one. Exact, because every predicate
    is word-local. Copy of ``repro/core/bytesops.py:635 fuse_ops``."""
    fused: list[Op] = []
    for op in ops:
        prev = fused[-1] if fused else None
        if prev is not None and prev.kind == op.kind == "lut":
            fused[-1] = lut_op(op.lut[prev.lut])
        elif prev is not None and prev.kind == op.kind == "collapse":
            pass  # idempotent
        elif prev is not None and prev.kind == op.kind == "wordpred":
            fused[-1] = wordpred_op(partial(pred_or, p1=prev.pred, p2=op.pred))
        else:
            fused.append(op)
    return fused


BACKENDS = ("loops", "fused", "device")
BACKEND_ENV = "REPRO_BYTES_BACKEND"

_IDENTITY_LUT = np.arange(256, dtype=np.uint8)


def resolve_backend(backend: str | None = None) -> str:
    """Explicit argument > ``REPRO_BYTES_BACKEND`` > ``device``
    (``repro/core/bytesops.py:664``, whose default is ``loops``)."""
    b = backend or os.environ.get(BACKEND_ENV, "") or "device"
    if b not in BACKENDS:
        raise ValueError(f"unknown bytes backend {b!r}; expected one of {BACKENDS}")
    return b


@dataclass(frozen=True)
class ScanPass:
    """A maximal LUT/SPAN run lowered to one sweep and one compaction.
    ``lut`` is the run's composed value LUT; ``spans`` holds one detector
    pair per span op, over the raw bytes (the preimage byte when unique,
    else a 256-entry boolean LUT); ``pairs`` the mapped (open, close)
    bytes. Copy of ``repro/core/bytesops.py:675 ScanPass``."""

    lut: np.ndarray
    spans: tuple[tuple[object, object], ...]
    pairs: tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class WordPass:
    """An optional pure-LUT prefix and a maximal COLLAPSE/WORDPRED run: one
    segmentation, the OR of the predicates, one space per gap. Copy of
    ``repro/core/bytesops.py:692 WordPass``; each predicate takes one
    word's bytes."""

    lut: np.ndarray | None
    preds: tuple[Callable[[bytes], bool], ...]


def _sep_safe(lut: np.ndarray) -> bool:
    """True iff ``lut`` maps ROW_SEP to ROW_SEP and nothing else to it
    (``repro/core/bytesops.py:702``)."""
    return bool(lut[ROW_SEP] == ROW_SEP and not (lut[1:] == ROW_SEP).any())


def _compose_luts(ops: Sequence[Op]) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:710``."""
    lut = _IDENTITY_LUT
    for op in ops:
        lut = op.lut[lut]
    return lut


def _detector(cur: np.ndarray, byte: int):
    """Raw-byte detector for ``cur[raw] == byte``: the preimage byte when
    unique, else the boolean LUT (``repro/core/bytesops.py:717``)."""
    pre = np.flatnonzero(cur == byte)
    if pre.size == 1:
        return int(pre[0])
    return cur == byte


def _detect(buf: np.ndarray, det) -> np.ndarray:
    """Copy of ``repro/core/bytesops.py:727``."""
    if isinstance(det, np.ndarray):
        return det[buf]
    return buf == det


def _compile_scan(run: Sequence[Op]) -> ScanPass | None:
    """``repro/core/bytesops.py:733 _compile_scan``."""
    cur = _IDENTITY_LUT
    spans: list[tuple[object, object]] = []
    pairs: list[tuple[int, int]] = []
    for op in run:
        if op.kind == "lut":
            cur = op.lut[cur]
        else:
            open_b, close_b = op.span
            # Raw-byte detection is not exact when the LUT so far moves the
            # separator or the delimiters are degenerate.
            if not _sep_safe(cur) or ROW_SEP in (open_b, close_b) or open_b == close_b:
                return None
            spans.append((_detector(cur, open_b), _detector(cur, close_b)))
            pairs.append((open_b, close_b))
    return ScanPass(lut=cur, spans=tuple(spans), pairs=tuple(pairs))


def compile_megapass(ops: Sequence[Op]) -> list[tuple[str, object]] | None:
    """Lower an op chain to a pass program ``[("scan", ScanPass) |
    ("word", WordPass) | ("op", Op), ...]``, or ``None`` when a segment
    cannot be proven byte-identical to sequential execution (the caller
    then runs :func:`apply_ops`). Copy of ``repro/core/bytesops.py:752``."""
    ops = list(ops)
    passes: list[tuple[str, object]] = []
    i, n = 0, len(ops)
    while i < n:
        kind = ops[i].kind
        if kind in ("replace", "regex"):
            passes.append(("op", ops[i]))
            i += 1
            continue
        head_lut: np.ndarray | None = None
        if kind in ("lut", "span"):
            j = i
            while j < n and ops[j].kind in ("lut", "span"):
                j += 1
            # A trailing pure-LUT suffix feeds the following word pass.
            t = j
            if j < n and ops[j].kind in ("collapse", "wordpred"):
                while t > i and ops[t - 1].kind == "lut":
                    t -= 1
            if t > i:
                scan = _compile_scan(ops[i:t])
                if scan is None:
                    return None
                passes.append(("scan", scan))
            if t < j:
                head_lut = _compose_luts(ops[t:j])
                if not _sep_safe(head_lut):
                    return None
            i = j
            if head_lut is None:
                continue
        if i < n and ops[i].kind in ("collapse", "wordpred"):
            j = i
            while j < n and ops[j].kind in ("collapse", "wordpred"):
                j += 1
            preds = tuple(op.pred for op in ops[i:j] if op.kind == "wordpred")
            passes.append(("word", WordPass(lut=head_lut, preds=preds)))
            i = j
            continue
        return None  # unknown op kind
    return passes


def _run_scan(buf: np.ndarray, sp: ScanPass) -> np.ndarray:
    """One host sweep for a LUT/SPAN run, span masks computed on the
    delimiter hits only. Same bytes as iterated :func:`span_strip`: depth
    resets at every separator, any byte at positive depth dies, every close
    byte dies, spans deleted by an earlier span op neither open, close nor
    count. Copy of ``repro/core/bytesops.py:805 _run_scan``."""
    identity = sp.lut is _IDENTITY_LUT
    if buf.size == 0 or not sp.spans:
        return buf if identity else sp.lut[buf]
    sep_idx = np.flatnonzero(buf == ROW_SEP)
    alive = np.ones(buf.size, dtype=bool)
    for open_det, close_det in sp.spans:
        opens = _detect(buf, open_det)
        closes = _detect(buf, close_det)
        np.logical_or(opens, closes, out=opens)
        hits = np.flatnonzero(opens)
        if hits.size:
            live = alive[hits]
            if not live.all():
                hits = hits[live]
        if hits.size == 0:
            continue
        is_close = closes[hits]
        sign = np.where(is_close, np.int32(-1), np.int32(1))
        g = np.cumsum(sign)
        rows_h = np.searchsorted(sep_idx, hits)  # hit's row (sep_idx entry = row end)
        first = np.ones(hits.size, dtype=bool)
        first[1:] = rows_h[1:] != rows_h[:-1]
        fpos = np.flatnonzero(first)
        counts = np.diff(np.append(fpos, hits.size))
        d = g - np.repeat((g - sign)[fpos], counts)  # row-local inclusive depth
        if sep_idx.size:
            row_end = np.where(
                rows_h < sep_idx.size,
                sep_idx[np.minimum(rows_h, sep_idx.size - 1)],
                buf.size,
            )
        else:
            row_end = np.full(hits.size, buf.size, dtype=np.int64)
        nxt = np.empty_like(hits)
        nxt[:-1] = hits[1:]
        nxt[-1] = buf.size
        end = np.minimum(nxt, row_end)
        inside = d > 0
        dead = inside | is_close
        # A byte at positive depth kills everything up to the next hit (or
        # the row's end, never the separator); a stray close kills itself.
        lens = np.where(inside, end - hits, 1)[dead]
        alive[_span_indices(hits[dead], lens)] = False
    out = buf[alive]
    return out if identity else sp.lut[out]


def _kernel_scan_args(sp: ScanPass) -> dict | None:
    """The ``text_scan`` kernel's flags for a scan pass, or ``None`` when
    the kernel does not compute it: the composed LUT must be the identity
    or lowercasing, the spans the canonical ``<>`` / ``()`` prefix in that
    order, and each span's detector exactly what the kernel tests
    (``lut[raw] == delimiter``). Copy of ``repro/core/bytesops.py:862
    _pallas_scan_args``."""
    if np.array_equal(sp.lut, LOWER_LUT):
        lower = True
    elif np.array_equal(sp.lut, _IDENTITY_LUT):
        lower = False
    else:
        return None
    allowed = ((ord("<"), ord(">")), (ord("("), ord(")")))
    if sp.pairs not in (allowed[:1], allowed[1:], allowed, ()):
        return None

    def det_array(det):
        return det if isinstance(det, np.ndarray) else _IDENTITY_LUT == det

    for (open_b, close_b), (open_det, close_det) in zip(sp.pairs, sp.spans):
        if not np.array_equal(det_array(open_det), sp.lut == open_b):
            return None
        if not np.array_equal(det_array(close_det), sp.lut == close_b):
            return None
    return {
        "lower": lower,
        "strip_html": allowed[0] in sp.pairs,
        "strip_parens": allowed[1] in sp.pairs,
    }


def _run_scan_device(buf: np.ndarray, sp: ScanPass, device) -> np.ndarray:
    """A scan pass on ``device`` through ``scan_flat`` (the card's
    ``text_scan`` kernel, or its plain version on the CPU), one call per
    pass. Counterpart of ``repro/core/bytesops.py:892 _run_scan_pallas``.

    The kernel computes a pass that :func:`_kernel_scan_args` accepts, that
    has a span, over a non-empty buffer whose last row is terminated. Any
    other pass (a pure-LUT run, a custom span, a delimiter whose preimage
    under the LUT is not one byte) is not the kernel's computation and runs
    through :func:`_run_scan` on the host: the reference's own shape rule
    (``bytesops.py:900-901``, ``kernels/text_clean/ops.py:113``), not a
    fallback. An error of the kernel raises; nothing re-runs it here."""
    kwargs = _kernel_scan_args(sp)
    if kwargs is None or not sp.spans or buf.size == 0 or buf[-1] != ROW_SEP:
        return _run_scan(buf, sp)
    from ..kernels.text_clean.ops import scan_flat

    return scan_flat(buf, **kwargs, device=device)


def _span_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices covering ``[starts[k], starts[k] + lens[k])`` for all k
    (``repro/core/bytesops.py:919``)."""
    total = int(lens.sum())
    cum = np.cumsum(lens) - lens
    return np.repeat(starts - cum, lens) + np.arange(total, dtype=np.int64)


def _run_word(buf: np.ndarray, wp: WordPass) -> np.ndarray:
    """The word pass: map by the head LUT, cut the buffer into words
    (maximal runs of bytes other than space and ROW_SEP), drop the words
    for which any predicate holds, and join the rest of each row with one
    space. Same bytes as ``repro/core/bytesops.py:927 _run_word``, whose
    keep mask emits each surviving word and one space per gap to the next
    one in its row. Predicates are word-local and pure (fusion's contract),
    so each is asked once per distinct word."""
    if buf.size == 0:
        return buf
    vals = buf if wp.lut is None else wp.lut[buf]
    # Separators become tokens of their own; empty tokens are the gaps.
    tokens = vals.tobytes().replace(b"\x00", b" \x00 ").split(b" ")
    drop = {b""}
    if wp.preds:
        drop.update(w for w in set(tokens)
                    if w and w != b"\x00" and any(p(w) for p in wp.preds))
    out = b" ".join([w for w in tokens if w not in drop])
    # A space beside a separator is the join's, never a gap between words.
    out = out.replace(b" \x00", b"\x00").replace(b"\x00 ", b"\x00")
    return np.frombuffer(out, dtype=np.uint8).copy()


def run_megapass(buf: np.ndarray, passes: Sequence[tuple[str, object]], *,
                 kernel: bool = False, device=None) -> np.ndarray:
    """Run a pass program; with ``kernel`` the scan passes go to
    :func:`_run_scan_device` on ``device`` (``repro/core/bytesops.py:982``,
    whose ``pallas`` flag this is)."""
    for kind, p in passes:
        if kind == "scan":
            buf = _run_scan_device(buf, p, device) if kernel else _run_scan(buf, p)
        elif kind == "word":
            buf = _run_word(buf, p)
        else:
            buf = apply_op(buf, p)
    return buf


# compile_megapass runs once per column and chain; memoize by op identity.
# Holding the ops keeps their ids live, so no other op can take one. The
# shard executor's threads share the memo: a lookup takes the entry (the
# ops and the program) in one read, so a clear by another thread cannot
# take it from under a reader, and a lock orders the clear and the store.
_MEGAPASS_CACHE: dict[tuple[int, ...], tuple[tuple[Op, ...], object]] = {}
_MEGAPASS_LOCK = threading.Lock()


def _compile_cached(ops: Sequence[Op]):
    """``repro/core/bytesops.py:1002 _compile_cached``, safe across threads."""
    key = tuple(id(op) for op in ops)
    hit = _MEGAPASS_CACHE.get(key)
    if hit is not None:
        return hit[1]
    prog = compile_megapass(ops)
    with _MEGAPASS_LOCK:
        if len(_MEGAPASS_CACHE) >= 128:
            _MEGAPASS_CACHE.clear()
        _MEGAPASS_CACHE[key] = (tuple(ops), prog)
    return prog


def execute_ops(buf: np.ndarray, ops: Sequence[Op], backend: str | None = None,
                device=None) -> np.ndarray:
    """Run an op chain under the selected backend; ``device`` is where the
    ``device`` backend's scan passes run (the card unless the caller names
    another). The same bytes under every backend; a chain the megapass
    compiler cannot prove exact runs as :func:`apply_ops`, as in
    ``repro/core/bytesops.py:1014 execute_ops``."""
    b = resolve_backend(backend)
    if b == "loops" or not ops:
        return apply_ops(buf, ops)
    prog = _compile_cached(ops)
    if prog is None:
        return apply_ops(buf, ops)
    return run_megapass(buf, prog, kernel=(b == "device"), device=device)
