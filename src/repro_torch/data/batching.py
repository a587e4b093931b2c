"""Batching operators: cleaned text columns to fixed-shape model inputs.

Copy of ``repro/data/batching.py``: the array-level operators of the lazy
``Dataset`` plan (:mod:`repro_torch.core.dataset`). A ``TokenSpec``
describes how one text column becomes one token array,
``encode_flat``/``encode_rows``/``encode_column`` execute it (vectorized
over the flat byte buffer, exact against the per-row oracle), and
``batches`` slices the arrays into fixed-shape batches: one ``max_len``
shape, or a small fixed set of length buckets (``bucket_by=``), a 2-D grid
when the encoder and decoder columns bucket together.

Two helpers are the port's own and stay for the paths that predate the
planner's port: ``seq2seq_arrays`` (the abstract and title lists encoded
one row at a time by ``WordTokenizer.encode``, the reference's per-row
oracle) and ``shuffled_batches`` (endless seeded batches trimmed to their
payload width).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from .tokenizer import END, PAD, START, UNK, WordTokenizer

# ``repro_torch.core.bytesops`` is imported inside the encoding functions,
# as the reference imports its own.


@dataclass(frozen=True)
class TokenSpec:
    """One text column → one fixed-length token array. Copy of ``repro/data/batching.py:28``."""

    column: str
    max_len: int
    out: str | None = None  # output array name; default "<column>_tokens"
    add_start_end: bool = False

    @property
    def name(self) -> str:
        return self.out or f"{self.column}_tokens"


def seq2seq_specs(
    max_abstract_len: int = 128,
    max_title_len: int = 24,
    abstract_col: str = "abstract",
    title_col: str = "title",
) -> tuple[TokenSpec, TokenSpec]:
    """The case-study encoding: abstract → encoder input, title → target.
    Copy of ``repro/data/batching.py:41``."""
    return (
        TokenSpec(abstract_col, max_abstract_len, out="encoder_tokens"),
        TokenSpec(title_col, max_title_len, out="decoder_tokens", add_start_end=True),
    )


# ---------------------------------------------------------------------------
# Vectorized encoding: hash the flat byte buffer per word, bulk-map via one
# vocab lookup table (exact — no hash collisions; see VocabTable)
# ---------------------------------------------------------------------------

# Bytes str.split() (no argument) treats as whitespace within ASCII:
# space, \t\n\v\f\r, and the file/group/record/unit separators \x1c-\x1f —
# plus the flat-buffer row separator. This LUT marks them all as word
# delimiters so byte-level segmentation matches str.split() exactly on
# ASCII rows. (Non-ASCII whitespace like \xa0 is multi-byte in UTF-8, so
# those rows take the per-row fallback anyway.)
_DELIM_LUT = np.zeros(256, dtype=bool)
for _b in (0, 9, 10, 11, 12, 13, 28, 29, 30, 31, 32):
    _DELIM_LUT[_b] = True

_HASH_C1 = 0x9E3779B97F4A7C15
_HASH_C2 = 0xC2B2AE3D27D4EB4F
_U64 = (1 << 64) - 1


class VocabTable:
    """Exact bulk word→id map over packed byte keys.

    Words of <=16 bytes are identified by ``(k1, k2, len)`` — bytes 0-7 and
    8-15 packed into two uint64 (zero padded) plus the byte length — which
    is collision-free, not a lossy hash: rows never contain NUL, so the
    zero padding cannot be confused with word bytes, and the length check
    separates a long word from a 16-byte word sharing its prefix. The map
    is an open-addressing hash table probed with vectorized gathers; every
    probe verifies full (k1, k2, len) equality, so a hash collision can
    only cost an extra probe, never a wrong id. Longer vocabulary words
    live in an exact bytes dict probed only for the rare >16-byte text
    words. Copy of
    ``repro/data/batching.py:74``."""

    def __init__(self, stoi: dict[str, int]):
        from ..core import bytesops as B

        self.stoi = dict(stoi)
        self.long: dict[bytes, int] = {}
        entries: list[tuple[int, int, int, int]] = []
        for w, i in self.stoi.items():
            try:
                raw = w.encode("utf-8")
            except UnicodeEncodeError:
                continue  # unencodable word can never appear in a buffer
            if len(raw) > 16:
                self.long[raw] = i
                continue
            k1, k2, ln = B.pack_word(w)
            entries.append((k1, k2, ln, i))
        bits = 8
        while (1 << bits) < 4 * max(len(entries), 1):
            bits += 1
        size = 1 << bits
        self._mask = size - 1
        self._shift = np.uint64(64 - bits)
        self.hk1 = np.zeros(size, dtype=np.uint64)
        self.hk2 = np.zeros(size, dtype=np.uint64)
        self.hln = np.full(size, -1, dtype=np.int32)  # -1 marks an empty slot
        self.hid = np.zeros(size, dtype=np.int32)
        self.max_probe = 0
        for k1, k2, ln, i in entries:
            h = (((k1 * _HASH_C1) & _U64) ^ ((k2 * _HASH_C2) & _U64)) >> (64 - bits)
            probe = 0
            while self.hln[h] != -1:
                h = (h + 1) & self._mask
                probe += 1
            self.hk1[h], self.hk2[h] = k1, k2
            self.hln[h], self.hid[h] = ln, i
            self.max_probe = max(self.max_probe, probe)

    def lookup_keys(
        self, k1: np.ndarray, k2: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        """ids (UNK default) for packed word keys — one vectorized gather
        + compare per probe step; a word stops probing at its entry or at
        the first empty slot (absent → UNK)."""
        ids = np.full(k1.size, UNK, dtype=np.int32)
        if ids.size == 0:
            return ids
        c1, c2 = np.uint64(_HASH_C1), np.uint64(_HASH_C2)
        with np.errstate(over="ignore"):  # uint64 wraparound is the hash
            h = (((k1 * c1) ^ (k2 * c2)) >> self._shift).astype(np.int64)
        # First probe full-width: the overwhelming majority of words
        # resolve here (hit their slot or see an empty one). The few
        # cluster-walkers then continue on compressed index arrays, so
        # later probes never re-gather the whole word set.
        ln_at = self.hln[h]
        ok = (self.hk1[h] == k1) & (self.hk2[h] == k2) & (ln_at == lengths)
        if ok.any():
            ids[ok] = self.hid[h[ok]]
        rem = np.flatnonzero(~ok & (ln_at != -1))
        if rem.size:
            h, k1, k2 = h[rem], k1[rem], k2[rem]
            lengths = lengths[rem]
            for _ in range(self.max_probe):
                h = (h + 1) & self._mask
                ln_at = self.hln[h]
                ok = (self.hk1[h] == k1) & (self.hk2[h] == k2) & (ln_at == lengths)
                if ok.any():
                    ids[rem[ok]] = self.hid[h[ok]]
                keep = ~ok & (ln_at != -1)
                if not keep.any():
                    break
                rem, h = rem[keep], h[keep]
                k1, k2, lengths = k1[keep], k2[keep], lengths[keep]
        return ids

    def lookup_long(self, word_bytes: bytes) -> int:
        return self.long.get(word_bytes, UNK)


def _encode_one(
    text: str | None, stoi: dict[str, int], max_len: int, add_start_end: bool
) -> np.ndarray:
    """The per-row oracle (and exact fallback for rows the vectorized path
    cannot represent as flat ASCII bytes). Copy of
    ``repro/data/batching.py:166``."""
    ids = [stoi.get(w, UNK) for w in (text or "").split()]
    if add_start_end:
        ids = [START] + ids[: max_len - 2] + [END]
    else:
        ids = ids[:max_len]
    row = np.full(max_len, PAD, dtype=np.int32)
    row[: len(ids)] = ids
    return row


# mask64[L] keeps the low min(L, 8) bytes of a little-endian uint64 load
_MASK64 = np.zeros(17, dtype=np.uint64)
for _L in range(17):
    _MASK64[_L] = np.uint64(0xFFFFFFFFFFFFFFFF if _L >= 8 else (1 << (8 * _L)) - 1)

_LITTLE_ENDIAN = __import__("sys").byteorder == "little"


def _unaligned_u64(u: np.ndarray, byte_idx: np.ndarray) -> np.ndarray:
    """Little-endian unaligned 64-bit loads from a uint64 view: two
    aligned gathers combined by per-element shifts (two gathers instead
    of eight byte gathers). Copy of
    ``repro/data/batching.py:189``."""
    w = byte_idx >> 3
    r = ((byte_idx & 7) << 3).astype(np.uint64)
    a = u[w] >> r
    b = u[w + 1] << ((np.uint64(64) - r) & np.uint64(63))
    return a | np.where(r == np.uint64(0), np.uint64(0), b)


def _gather_u64_bytes(bufp: np.ndarray, byte_idx: np.ndarray) -> np.ndarray:
    """Byte-order-independent fallback: 8 byte gathers into a uint64 view
    (matches ``pack_word``'s native-order frombuffer packing). Copy of
    ``repro/data/batching.py:200``."""
    mat = np.empty((byte_idx.size, 8), dtype=np.uint8)
    idx = byte_idx.copy()
    for j in range(8):
        np.take(bufp, idx, out=mat[:, j])
        idx += 1
    return mat.reshape(-1).view(np.uint64)


def _pack_word_keys(
    bufp: np.ndarray, start_idx: np.ndarray, lengths: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(k1, k2) packed keys of every word, masked to the word length
    (bytes beyond a word are neighbor garbage from the load, not
    guaranteed zero). ``bufp`` must be zero-padded to a multiple of 8
    bytes with at least 16 bytes of slack after the last word start. Copy of
    ``repro/data/batching.py:211``."""
    if _LITTLE_ENDIAN:
        u = bufp.view(np.uint64)
        k1 = _unaligned_u64(u, start_idx)
    else:  # pragma: no cover - big-endian fallback
        k1 = _gather_u64_bytes(bufp, start_idx)
    k1 &= _MASK64[np.minimum(lengths, 16)]
    k2 = np.zeros(start_idx.size, dtype=np.uint64)
    long8 = np.flatnonzero(lengths > 8)
    if long8.size:
        idx2 = start_idx[long8] + 8
        if _LITTLE_ENDIAN:
            kk = _unaligned_u64(bufp.view(np.uint64), idx2)
        else:  # pragma: no cover - big-endian fallback
            kk = _gather_u64_bytes(bufp, idx2)
        kk &= _MASK64[np.minimum(lengths[long8] - 8, 16)]
        k2[long8] = kk
    return k1, k2


def encode_flat(
    buf: np.ndarray,
    table: VocabTable,
    max_len: int,
    add_start_end: bool = False,
) -> np.ndarray:
    """Encode a flat byte buffer to a (rows, max_len) int32 array without
    a per-row Python loop: segment words once, pack each word's bytes into
    exact 16-byte keys, bulk-map them through the :class:`VocabTable`, and
    scatter into the output. Rows containing non-ASCII bytes fall back to
    the per-row oracle (multi-byte whitespace and decode-dependent
    splitting make them irreducibly row-wise), so the result is
    byte-identical to encoding the decoded rows one by one. Copy of
    ``repro/data/batching.py:237``."""
    from ..core import bytesops as B

    sep_pos = np.flatnonzero(buf == B.ROW_SEP)
    n = sep_pos.size
    out = np.full((n, max_len), PAD, dtype=np.int32)
    if n == 0:
        return out
    cap = max_len - 2 if add_start_end else max_len
    if add_start_end:
        out[:, 0] = START
    delim = _DELIM_LUT[buf]
    isw = ~delim
    starts = isw.copy()
    starts[1:] &= delim[:-1]
    ends = isw  # reuse; isw not needed afterwards
    ends[:-1] &= delim[1:]
    start_idx = np.flatnonzero(starts)
    counts = np.zeros(n, dtype=np.int64)
    if start_idx.size:
        # Word bytes never include whitespace, so keys pack straight from
        # the original buffer.
        lengths = (np.flatnonzero(ends) - start_idx + 1).astype(np.int32)
        word_rows = np.searchsorted(sep_pos, start_idx)
        pad = 16 + (-(buf.size + 16)) % 8
        bufp = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
        k1, k2 = _pack_word_keys(bufp, start_idx, lengths)
        ids = table.lookup_keys(k1, k2, lengths)
        for p in np.flatnonzero(lengths > 16):  # rare >16-byte words
            s, ln = int(start_idx[p]), int(lengths[p])
            ids[p] = table.lookup_long(buf[s : s + ln].tobytes())
        counts = np.bincount(word_rows, minlength=n)
        first = np.concatenate(([0], np.cumsum(counts)[:-1]))
        colpos = np.arange(word_rows.size, dtype=np.int64) - first[word_rows]
        m = colpos < cap
        if add_start_end:
            out[word_rows[m], colpos[m] + 1] = ids[m]
        else:
            out[word_rows[m], colpos[m]] = ids[m]
    if add_start_end:
        endpos = np.minimum(counts, max(cap, 0)) + 1
        out[np.arange(n), np.minimum(endpos, max_len - 1)] = END
    nonascii = np.flatnonzero(buf >= 128)
    if nonascii.size:
        bad = np.zeros(n, dtype=bool)
        bad[np.searchsorted(sep_pos, nonascii)] = True
        row_starts = np.concatenate(([0], sep_pos[:-1] + 1))
        raw = buf.tobytes()
        for r in np.flatnonzero(bad):
            t = raw[row_starts[r] : sep_pos[r]].decode("utf-8", errors="ignore")
            out[r] = _encode_one(t, table.stoi, max_len, add_start_end)
    return out


def encode_rows(
    texts: Sequence[str | None],
    stoi: dict[str, int],
    max_len: int,
    add_start_end: bool = False,
    table: VocabTable | None = None,
) -> np.ndarray:
    """Encode rows against a word-index map into one (n, max_len) int32
    array. This is the single encoding implementation: the eager oracle
    (:func:`encode_column`) and the per-shard executor token step
    (:mod:`repro_torch.core.executor`) both route through it / through
    :func:`encode_flat`, so they are byte-identical by construction.

    Vectorized: ASCII rows flatten into one byte buffer and bulk-encode
    (:func:`encode_flat`); rows the buffer cannot represent exactly
    (non-ASCII, NUL, non-string values) take the per-row oracle. Pass a
    prebuilt ``table`` when encoding many batches against one vocabulary.
    Copy of ``repro/data/batching.py:303``.
    """
    from ..core import bytesops as B

    n = len(texts)
    rows: list[str] = []
    fallback: list[int] = []
    for i, t in enumerate(texts):
        if t is None:
            rows.append("")
        elif isinstance(t, str) and t.isascii() and "\x00" not in t:
            rows.append(t)
        else:
            rows.append("")
            fallback.append(i)
    if table is None:
        table = VocabTable(stoi)
    out = encode_flat(B.flatten(rows), table, max_len, add_start_end)
    if out.shape[0] != n:  # pragma: no cover - flatten invariant
        out = np.full((n, max_len), PAD, dtype=np.int32)
        fallback = list(range(n))
    for i in fallback:
        out[i] = _encode_one(texts[i], stoi, max_len, add_start_end)
    return out


def encode_column(
    texts: Sequence[str | None],
    tokenizer: WordTokenizer,
    max_len: int,
    add_start_end: bool = False,
) -> np.ndarray:
    """Copy of ``repro/data/batching.py:345``."""
    return encode_rows(texts, tokenizer.stoi, max_len, add_start_end)


def encode_frame_columns(
    columns: dict[str, Sequence[str | None]],
    tokenizer: WordTokenizer,
    specs: Sequence[TokenSpec],
) -> dict[str, np.ndarray]:
    """Copy of ``repro/data/batching.py:354``."""
    return {
        spec.name: encode_column(
            columns[spec.column], tokenizer, spec.max_len, spec.add_start_end
        )
        for spec in specs
    }


def seq2seq_arrays(abstracts: Sequence[str], titles: Sequence[str], tok: WordTokenizer,
                   max_abstract_len: int = 128, max_title_len: int = 24) -> dict[str, np.ndarray]:
    """``encoder_tokens`` (n, max_abstract_len) and ``decoder_tokens``
    (n, max_title_len), int32, PAD-filled: the arrays of
    ``repro/data/batching.py:367 seq2seq_arrays``, which takes records."""
    def encode(texts, max_len, add_start_end):
        if not texts:
            return np.zeros((0, max_len), dtype=np.int32)
        return np.stack([tok.encode(t or "", max_len, add_start_end) for t in texts])

    return {"encoder_tokens": encode(abstracts, max_abstract_len, False),
            "decoder_tokens": encode(titles, max_title_len, True)}


# ---------------------------------------------------------------------------
# Length-bucketed assembly
# ---------------------------------------------------------------------------


def effective_lengths(arr: np.ndarray) -> np.ndarray:
    """Per-row payload length of a padded token array: 1 + index of the
    last non-PAD token (0 for all-PAD rows). Trailing padding beyond it is
    droppable without losing information, even if PAD ids appear *inside*
    the row (a literal ``<pad>`` word encodes to 0). Copy of
    ``repro/data/batching.py:389``."""
    nonpad = arr != PAD
    lens = arr.shape[1] - np.argmax(nonpad[:, ::-1], axis=1)
    return np.where(nonpad.any(axis=1), lens, 0).astype(np.int64)


def derive_buckets(max_len: int, n_buckets: int = 4) -> tuple[int, ...]:
    """A small fixed set of bucket widths ending at ``max_len`` (linear
    steps, deduplicated) — bounded shape set, jit-compilation friendly. Copy of
    ``repro/data/batching.py:399``."""
    n = max(int(n_buckets), 1)
    widths = sorted({max(1, (max_len * i) // n) for i in range(1, n + 1)} | {max_len})
    return tuple(widths)


def assign_buckets(lengths: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Index of the smallest bucket wide enough for each row. Rows longer
    than the last bucket land in it (they were already truncated to
    ``max_len`` == the last bucket by encoding). Copy of
    ``repro/data/batching.py:407``."""
    edges = np.asarray(buckets, dtype=np.int64)
    idx = np.searchsorted(edges, np.asarray(lengths, dtype=np.int64), side="left")
    return np.minimum(idx, len(edges) - 1)


def bucket_columns(bucket_by: str | Sequence[str]) -> tuple[str, ...]:
    """Normalize ``bucket_by`` (one column name or several) to a tuple.
    Copy of ``repro/data/batching.py:416``."""
    return (bucket_by,) if isinstance(bucket_by, str) else tuple(bucket_by)


def bucket_grid(
    bucket_by: str | Sequence[str],
    buckets: Sequence,
    arrays: dict[str, np.ndarray] | None = None,
) -> tuple[tuple[str, ...], tuple[tuple[int, ...], ...]]:
    """(columns, per-column bucket widths). ``buckets`` may be a flat int
    sequence (single column), a nested per-column sequence, or empty —
    then widths derive from each column's array width. Copy of
    ``repro/data/batching.py:421``."""
    cols = bucket_columns(bucket_by)
    if not buckets:
        if arrays is None:
            raise ValueError("bucket widths unset and no arrays to derive them from")
        return cols, tuple(derive_buckets(arrays[c].shape[1]) for c in cols)
    if isinstance(buckets[0], (int, np.integer)):
        if len(cols) != 1:
            raise ValueError(
                f"flat bucket widths with {len(cols)} bucket columns; pass one "
                "width list per column"
            )
        return cols, (tuple(int(b) for b in buckets),)
    if len(buckets) != len(cols):
        raise ValueError(
            f"{len(buckets)} bucket width lists for {len(cols)} bucket columns"
        )
    return cols, tuple(tuple(int(b) for b in bs) for bs in buckets)


def _grid_assignment(
    arrays: dict[str, np.ndarray],
    cols: Sequence[str],
    grid: Sequence[Sequence[int]],
) -> np.ndarray:
    """Composite bucket-cell index per row (row-major over the grid — the
    same order ``itertools.product`` enumerates). Copy of
    ``repro/data/batching.py:448``."""
    n = len(next(iter(arrays.values())))
    assign = np.zeros(n, dtype=np.int64)
    for c, widths in zip(cols, grid):
        assign = assign * len(widths) + assign_buckets(
            effective_lengths(arrays[c]), widths
        )
    return assign


def slice_to_bucket(
    batch: dict[str, np.ndarray], widths: dict[str, int]
) -> dict[str, np.ndarray]:
    """Slice each bucketed column to its cell width. Copy of ``repro/data/batching.py:464``."""
    return {
        k: (v[:, : widths[k]] if k in widths else v) for k, v in batch.items()
    }


def pad_token_fraction(batches: Sequence[dict[str, np.ndarray]], column: str) -> float:
    """Fraction of entries in ``column`` that are padding beyond each row's
    payload — the accelerator-cycle waste bucketing removes. Copy of
    ``repro/data/batching.py:473``."""
    pad = total = 0
    for b in batches:
        arr = b[column]
        total += arr.size
        pad += int(arr.size - effective_lengths(arr).sum())
    return pad / total if total else 0.0


def pad_batch(batch: dict[str, np.ndarray], rows: int) -> dict[str, np.ndarray]:
    """Pad a partial batch with PAD rows up to ``rows`` (shape stability).
    Copy of ``repro/data/batching.py:484``."""
    n = len(next(iter(batch.values())))
    if n >= rows:
        return batch
    out = {}
    for k, v in batch.items():
        padded = np.full((rows,) + v.shape[1:], PAD, dtype=v.dtype)
        padded[:n] = v
        out[k] = padded
    return out


def emit_bucketed(
    arrays: dict[str, np.ndarray],
    order: np.ndarray,
    batch_size: int,
    bucket_by: str | Sequence[str],
    buckets: Sequence,
) -> tuple[list[dict[str, np.ndarray]], np.ndarray]:
    """(full bucket batches in ``order``-scan order, leftover row indices).

    Rows are scanned in ``order``; each full batch keeps only rows of one
    bucket cell and each bucketed column is sliced to its cell width. With
    several ``bucket_by`` columns the cells form a fixed grid (paired
    encoder/decoder bucketing: decoder padding drops too). Leftovers
    (per-cell remainders) come back for the caller to carry, pad, or
    drop. Copy of
    ``repro/data/batching.py:497``."""
    from itertools import product

    cols, grid = bucket_grid(bucket_by, buckets, arrays)
    assignment = _grid_assignment(arrays, cols, grid)
    out: list[dict[str, np.ndarray]] = []
    leftovers: list[np.ndarray] = []
    for ci, cell in enumerate(product(*grid)):
        rows = order[assignment[order] == ci]
        if not rows.size:
            continue
        widths = dict(zip(cols, cell))
        full = (len(rows) // batch_size) * batch_size
        for s in range(0, full, batch_size):
            sel = rows[s : s + batch_size]
            out.append(
                slice_to_bucket({k: v[sel] for k, v in arrays.items()}, widths)
            )
        if full < len(rows):
            leftovers.append(rows[full:])
    rest = (
        np.concatenate(leftovers)
        if leftovers
        else np.zeros(0, dtype=np.int64)
    )
    return out, rest


def emit_remainders(
    rows: dict[str, np.ndarray],
    bucket_by: str | Sequence[str],
    buckets: Sequence,
    pad_to: int | None,
    drop_remainder: bool,
) -> list[dict[str, np.ndarray]]:
    """Per-cell remainder batches under the remainder policy (empty when
    dropped). Remainders stay per-cell so every emitted batch keeps a
    bucket-grid shape and at most batch_size rows — never one concatenated
    full-width catch-all. Shared by the whole-frame and streaming
    assemblers so their remainder semantics cannot drift. Copy of
    ``repro/data/batching.py:539``."""
    from itertools import product

    out: list[dict[str, np.ndarray]] = []
    if (pad_to is None and drop_remainder) or not len(next(iter(rows.values()))):
        return out
    cols, grid = bucket_grid(bucket_by, buckets, rows)
    assignment = _grid_assignment(rows, cols, grid)
    cells = list(product(*grid))
    for ci in np.unique(assignment):
        part = {k: v[assignment == ci] for k, v in rows.items()}
        if pad_to is not None:
            part = pad_batch(part, pad_to)
        out.append(slice_to_bucket(part, dict(zip(cols, cells[ci]))))
    return out


def batches(
    arrays: dict[str, np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    pad_to: int | None = None,
    bucket_by: str | Sequence[str] | None = None,
    buckets: Sequence = (),
) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-size batches; a ``pad_to`` remainder is padded instead of
    dropped. With ``bucket_by``, rows are grouped by payload length into
    the fixed ``buckets`` widths and each bucketed column is sliced to its
    bucket — every batch still has one of a small fixed set of static
    shapes (a grid when several columns bucket together). Copy of
    ``repro/data/batching.py:567``."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    if bucket_by is not None:
        _, buckets = bucket_grid(bucket_by, buckets, arrays)
        out, rest = emit_bucketed(arrays, idx, batch_size, bucket_by, buckets)
        out.extend(
            emit_remainders(
                {k: v[rest] for k, v in arrays.items()},
                bucket_by, buckets, pad_to, drop_remainder,
            )
        )
        if shuffle:
            rng.shuffle(out)
        yield from out
        return
    stop = (n // batch_size) * batch_size if drop_remainder and pad_to is None else n
    for s in range(0, stop, batch_size):
        sel = idx[s : s + batch_size]
        batch = {k: v[sel] for k, v in arrays.items()}
        if pad_to is not None and len(sel) < batch_size:
            batch = pad_batch(batch, pad_to)
        yield batch


def split_indices(
    n: int, val_fraction: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) index partition — the one split rule shared by
    ``train_val_split`` and ``Dataset.split``. Copy of
    ``repro/data/batching.py:610``."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    n_val = max(int(n * val_fraction), 1) if n else 0
    return idx[n_val:], idx[:n_val]


def train_val_split(
    arrays: dict[str, np.ndarray], val_fraction: float = 0.1, seed: int = 0
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Copy of ``repro/data/batching.py:621``."""
    n = len(next(iter(arrays.values())))
    train, val = split_indices(n, val_fraction, seed)
    return (
        {k: v[train] for k, v in arrays.items()},
        {k: v[val] for k, v in arrays.items()},
    )


def payload_width(arr: np.ndarray) -> int:
    """1 + the index of the last non-PAD column of any row (at least 1):
    the columns beyond it are PAD in every row."""
    nonpad = (arr != PAD).any(axis=0)
    return max(1, int(np.flatnonzero(nonpad)[-1]) + 1) if nonpad.any() else 1


def shuffled_batches(arrays: dict[str, np.ndarray], batch_size: int, *,
                     seed: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches of ``batch_size`` rows in a seeded shuffle, a new
    order each epoch, the last batch of an epoch short; every array trimmed to its payload width, so that
    ``BucketGrid.snap`` puts the batch on the smallest rung that holds it.
    The planner's ``batched(bucket_by=...)`` groups rows by their bucket
    cell instead (:func:`batches`)."""
    n = len(next(iter(arrays.values())))
    if n == 0:
        raise ValueError("no rows to batch")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for s in range(0, n, batch_size):
            rows = order[s : s + batch_size]
            batch = {k: v[rows] for k, v in arrays.items()}
            yield {k: v[:, : payload_width(v)] for k, v in batch.items()}
