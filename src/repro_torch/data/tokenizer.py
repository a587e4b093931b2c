"""Word-level tokenizer for the title-generation case study.

Copy of ``repro/data/tokenizer.py:1-107`` (the whole file): the same
tie-break, so the same vocabulary from the same cleaned text.

The paper's Keras lineage uses a Keras ``Tokenizer`` (word-index map built
from the cleaned corpus). Same here: vocabulary = most frequent words of
the cleaned text, with the four specials the seq2seq decoder needs.

Fitting is a count aggregation, which makes it distributable exactly like
Spark's ``CountVectorizer``: each shard counts its own words, the driver
merges the ``Counter``s, and :meth:`WordTokenizer.from_counts` turns the
merged counts into a vocabulary. Ordering is deterministic — count
descending, then word ascending — so a whole-frame fit and a shard-merged
fit of the same corpus always produce the same vocabulary (plain
``Counter.most_common`` breaks ties by insertion order, which differs
between the two).
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from pathlib import Path
from typing import Iterable, Mapping, Sequence

import numpy as np

PAD, START, END, UNK = 0, 1, 2, 3
SPECIALS = ("<pad>", "<start>", "<end>", "<unk>")


def top_words(counts: Mapping[str, int], n: int) -> list[str]:
    """The ``n`` most frequent words under the deterministic tie-break
    (count desc, word asc) — insertion-order independent, so shard-merged
    and whole-corpus counts rank identically."""
    if n <= 0:
        return []
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return [w for w, _ in ranked[:n]]


class WordTokenizer:
    def __init__(self, vocab: Sequence[str]):
        self.itos: list[str] = list(SPECIALS) + [w for w in vocab if w not in SPECIALS]
        self.stoi: dict[str, int] = {w: i for i, w in enumerate(self.itos)}

    @classmethod
    def from_counts(
        cls, counts: Mapping[str, int], vocab_size: int = 8000
    ) -> "WordTokenizer":
        """Build from (possibly shard-merged) word counts — the ``fit``
        half of the Spark CountVectorizer-style fit/transform split."""
        return cls(top_words(counts, max(vocab_size - len(SPECIALS), 0)))

    @classmethod
    def fit(cls, texts: Iterable[str], vocab_size: int = 8000) -> "WordTokenizer":
        counts: Counter = Counter()
        for t in texts:
            counts.update(t.split())
        return cls.from_counts(counts, vocab_size)

    def __len__(self) -> int:
        return len(self.itos)

    @property
    def fingerprint(self) -> str:
        """Stable content hash of the vocabulary (order-sensitive). Token
        cache entries are keyed by it, so refitting with different data or
        a different ``vocab_size`` invalidates cached token arrays without
        touching the cleaned-text entries."""
        h = hashlib.blake2b(digest_size=16)
        for w in self.itos:
            enc = w.encode("utf-8", errors="surrogatepass")
            h.update(len(enc).to_bytes(4, "little"))
            h.update(enc)
        return h.hexdigest()

    def encode(self, text: str, max_len: int, add_start_end: bool = False) -> np.ndarray:
        ids = [self.stoi.get(w, UNK) for w in text.split()]
        if add_start_end:
            ids = [START] + ids[: max_len - 2] + [END]
        else:
            ids = ids[:max_len]
        out = np.full(max_len, PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        words = []
        for i in ids:
            if i == END:
                break
            if i in (PAD, START):
                continue
            words.append(self.itos[int(i)] if int(i) < len(self.itos) else "<unk>")
        return " ".join(words)

    # -- persistence (checkpointed with the model) -------------------------
    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.itos))

    @classmethod
    def load(cls, path: str | Path) -> "WordTokenizer":
        itos = json.loads(Path(path).read_text())
        tok = cls.__new__(cls)
        tok.itos = itos
        tok.stoi = {w: i for i, w in enumerate(itos)}
        return tok
