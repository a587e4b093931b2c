"""Synthetic CORE-dataset records with the dirt the cleaning chain removes.

Copy of ``repro/data/synthetic.py:38-154`` (``CorpusGenerator``) and
``:157`` (``write_corpus``, with the standard library's ``json``): HTML tags
around random spans, parenthetical asides, digits, punctuation,
contractions, mixed case and stopwords, ~4% null titles/abstracts and ~3%
exact duplicates. Tags and parentheses are balanced and non-nested per
field. Deterministic for a given seed.
"""

from __future__ import annotations

import itertools
import json
import random
from pathlib import Path
from typing import Iterator

_SYLLABLES = (
    "al an ar as at con cor de den der dis ec en er es ex for gen ic il in "
    "is it lec men ment mod nal ner nol og on or per pre pro qua re ric sec "
    "sen ser sis sta sys tal tec ter tic tion tor tra tri tur ul ur ver vis"
).split()

_STOPWORDS = (
    "the of and to in a is that for it as was with be by on not he i this "
    "are or his from at which but have an had they you were their one all we "
    "can her has there been if more when will would who so no"
).split()

_CONTRACTIONS = ["can't", "won't", "isn't", "doesn't", "it's", "we're", "they've", "he'd"]
_TAGS = ["p", "i", "b", "em", "sub", "sup"]
_PUNCT = [".", ",", ";", ":", "!", "?"]

CORE_FIELDS = [
    "doi", "coreId", "oai", "identifiers", "title", "authors", "contributors",
    "datePublished", "abstract", "downloadUrl", "publisher", "journals",
    "language", "relations", "year", "topics", "subjects", "fullText",
]


class CorpusGenerator:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        # Zipf-ish vocabulary of pseudo-words, cumulative weights precomputed.
        n_vocab = 4000
        self.vocab = [self._make_word() for _ in range(n_vocab)]
        weights = [1.0 / (i + 1) for i in range(n_vocab)]
        self.cum_weights = list(itertools.accumulate(weights))

    def _make_word(self) -> str:
        r = self.rng
        return "".join(r.choice(_SYLLABLES) for _ in range(r.randint(2, 4)))

    def _words(self, n: int) -> list[str]:
        r = self.rng
        out: list[str] = []
        for _ in range(n):
            if r.random() < 0.35:
                out.append(r.choice(_STOPWORDS))
            else:
                out.append(r.choices(self.vocab, cum_weights=self.cum_weights, k=1)[0])
        return out

    def _dirty_text(self, n_words: int, *, html_p: float, paren_p: float) -> str:
        """Natural-ish dirty text with balanced, non-nested tags/parens."""
        r = self.rng
        words = self._words(n_words)
        out: list[str] = []
        i = 0
        while i < len(words):
            roll = r.random()
            if roll < html_p and i + 2 < len(words):
                tag = r.choice(_TAGS)
                span = words[i : i + r.randint(1, 3)]
                out.append(f"<{tag}>" + " ".join(span) + f"</{tag}>")
                i += len(span)
            elif roll < html_p + paren_p and i + 2 < len(words):
                span = words[i : i + r.randint(1, 4)]
                out.append("(" + " ".join(span) + ")")
                i += len(span)
            else:
                w = words[i]
                if r.random() < 0.08:
                    w = w.capitalize()
                if r.random() < 0.05:
                    w = r.choice(_CONTRACTIONS)
                if r.random() < 0.04:
                    w = str(r.randint(0, 2030))
                if r.random() < 0.12:
                    w += r.choice(_PUNCT)
                out.append(w)
                i += 1
        return " ".join(out)

    def record(self) -> dict:
        r = self.rng
        title = None if r.random() < 0.04 else self._dirty_text(
            r.randint(6, 14), html_p=0.05, paren_p=0.04
        )
        abstract = None if r.random() < 0.04 else self._dirty_text(
            r.randint(60, 220), html_p=0.04, paren_p=0.05
        )
        year = r.randint(1990, 2019)
        rec = {f: None for f in CORE_FIELDS}
        rec.update(
            {
                "doi": f"10.{r.randint(1000, 9999)}/{r.randint(100000, 999999)}",
                "coreId": str(r.randint(10**7, 10**8)),
                "title": title,
                "authors": [self._make_word().capitalize() for _ in range(r.randint(1, 4))],
                "datePublished": f"{year}-01-01",
                "abstract": abstract,
                "publisher": self._make_word().capitalize(),
                "language": "en",
                "year": year,
                "topics": [self._make_word() for _ in range(r.randint(0, 3))],
                "subjects": [],
            }
        )
        return rec

    def records(self) -> Iterator[dict]:
        recent: list[dict] = []
        while True:
            if recent and self.rng.random() < 0.03:
                yield dict(self.rng.choice(recent))  # duplicate
                continue
            rec = self.record()
            recent.append(rec)
            if len(recent) > 500:
                recent.pop(0)
            yield rec


def write_corpus(
    out_dir: str | Path,
    total_bytes: int,
    n_files: int = 8,
    seed: int = 0,
) -> list[Path]:
    """Write ~total_bytes of JSONL across n_files of deliberately unequal size
    (the paper's shards range KB..GB)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = CorpusGenerator(seed)
    it = gen.records()
    rng = random.Random(seed + 1)
    # Unequal byte budgets per file.
    raw = [rng.uniform(0.3, 1.7) for _ in range(n_files)]
    budgets = [int(total_bytes * w / sum(raw)) for w in raw]
    paths = []
    for i, budget in enumerate(budgets):
        p = out_dir / f"shard_{i:04d}.jsonl"
        written = 0
        with open(p, "wb") as fh:
            while written < budget:
                line = json.dumps(next(it), separators=(",", ":")).encode() + b"\n"
                fh.write(line)
                written += len(line)
        paths.append(p)
    return paths


def abstracts_and_titles(n: int, seed: int = 0) -> tuple[list[str], list[str]]:
    """The raw (dirty) abstracts and titles of the first ``n`` generated
    records that have both fields."""
    abstracts: list[str] = []
    titles: list[str] = []
    for rec in CorpusGenerator(seed).records():
        if len(abstracts) == n:
            break
        if rec["abstract"] and rec["title"]:
            abstracts.append(rec["abstract"])
            titles.append(rec["title"])
    return abstracts, titles
