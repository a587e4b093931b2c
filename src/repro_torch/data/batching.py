"""Cleaned text columns to the summarizer's token arrays.

Copies from ``repro/data/batching.py``: ``derive_buckets`` (``:399-404``),
``split_indices`` (``:610-618``) and the case-study encoding of
``seq2seq_specs`` (``:41-51``): the abstract becomes ``encoder_tokens``
(``max_abstract_len`` wide), the title ``decoder_tokens`` with START and
END (``max_title_len`` wide). Rows are encoded one at a time by
``WordTokenizer.encode``, the reference's per-row oracle; its vectorized
``encode_rows`` gives the same arrays. ``shuffled_batches`` is the port's
own batch assembly until the planner is ported.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from .tokenizer import PAD, WordTokenizer


def derive_buckets(max_len: int, n_buckets: int = 4) -> tuple[int, ...]:
    """A small fixed set of bucket widths ending at ``max_len`` (linear
    steps, deduplicated)."""
    n = max(int(n_buckets), 1)
    widths = sorted({max(1, (max_len * i) // n) for i in range(1, n + 1)} | {max_len})
    return tuple(widths)


def split_indices(n: int, val_fraction: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) index partition from a seeded shuffle; at least one
    validation row when there are rows."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    n_val = max(int(n * val_fraction), 1) if n else 0
    return idx[n_val:], idx[:n_val]


def seq2seq_arrays(abstracts: Sequence[str], titles: Sequence[str], tok: WordTokenizer,
                   max_abstract_len: int = 128, max_title_len: int = 24) -> dict[str, np.ndarray]:
    """``encoder_tokens`` (n, max_abstract_len) and ``decoder_tokens``
    (n, max_title_len), int32, PAD-filled."""
    def encode(texts, max_len, add_start_end):
        if not texts:
            return np.zeros((0, max_len), dtype=np.int32)
        return np.stack([tok.encode(t or "", max_len, add_start_end) for t in texts])

    return {"encoder_tokens": encode(abstracts, max_abstract_len, False),
            "decoder_tokens": encode(titles, max_title_len, True)}


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
    The reference groups rows by their bucket cell in the planner's
    ``batched(bucket_by=...)`` (ROADMAP Queue 1, the planner)."""
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
