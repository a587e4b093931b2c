"""Host byte operations of the cleaning chains, on flat row buffers.

Copies of what the serving chains, the ``col()`` chains of
``repro_torch.core.expr`` and the stage pipeline need from
``repro/core/bytesops.py``: a column of ``n`` strings is one uint8 array
whose rows each end in ``ROW_SEP`` (``\\x00``). The serving chains run the
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

import os
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


def pred_or(word: bytes, p1, p2) -> bool:
    """The OR of two word predicates, as fusion builds it."""
    return p1(word) or p2(word)


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
        if kind == "replace":
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
# Holding the ops keeps their ids live, so no other op can take one.
_MEGAPASS_CACHE: dict[tuple[int, ...], tuple[tuple[Op, ...], object]] = {}


def _compile_cached(ops: Sequence[Op]):
    """``repro/core/bytesops.py:1002 _compile_cached``."""
    key = tuple(id(op) for op in ops)
    hit = _MEGAPASS_CACHE.get(key)
    if hit is not None:
        return hit[1]
    prog = compile_megapass(ops)
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
