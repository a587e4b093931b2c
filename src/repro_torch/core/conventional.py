"""The conventional approach (CA): Algorithm 2 of the paper.

Copy of ``repro/core/conventional.py``: ``RowFrame`` (``:28``),
``ingest_conventional``, ``pre_clean_conventional``,
``clean_conventional`` and ``post_clean_conventional`` (``:42-88``).

CA is the pandas idiom of the paper's time:

* ingest: per file, parse the records and ``DataFrame.append`` them.
  Append copies the whole frame, so ingestion grows super-linearly (the
  paper's Table 2). ``RowFrame`` keeps that copy-on-append with the
  standard library's ``json`` as the parser;
* cleaning: a Python loop over the rows applying each stage's row-wise
  oracle (Algorithm 2, steps 11-13).

It is the measured baseline of the comparison and the reference of the
record-match accuracy study (paper Tables 5-6).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

from .ingest import _normalize, list_shards
from .stages import Stage


class RowFrame:
    """A pandas-era DataFrame: a copy-on-append row store."""

    def __init__(self, rows: list[dict] | None = None):
        self.rows: list[dict] = rows if rows is not None else []

    def append(self, other: "RowFrame") -> "RowFrame":
        # pd.DataFrame.append returned a NEW frame, copying both inputs.
        return RowFrame([dict(r) for r in self.rows] + [dict(r) for r in other.rows])

    def __len__(self) -> int:
        return len(self.rows)


def ingest_conventional(
    directories: Sequence[str | Path], fields: Sequence[str] = ("title", "abstract")
) -> RowFrame:
    """Algorithm 2 steps 1-8."""
    data = RowFrame()
    for path in list_shards(directories):
        rows = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                # The columnar ingestion's NUL normalisation, so both
                # approaches see the same input.
                rows.append({f: _normalize(rec.get(f)) for f in fields})
        data = data.append(RowFrame(rows))
    return data


def pre_clean_conventional(frame: RowFrame, fields: Sequence[str]) -> RowFrame:
    """Algorithm 2 steps 9-10: drop nulls, drop duplicates (keep first)."""
    out: list[dict] = []
    seen: set = set()
    for r in frame.rows:
        if any(r.get(f) is None or r.get(f) == "" for f in fields):
            continue
        key = tuple(r.get(f) for f in fields)
        if key in seen:
            continue
        seen.add(key)
        out.append(r)
    return RowFrame(out)


def clean_conventional(frame: RowFrame, stages: Sequence[Stage]) -> RowFrame:
    """Algorithm 2 steps 11-13: for all rows, clean the text."""
    for st in stages:
        for r in frame.rows:
            val = r.get(st.input_col) or ""
            r[st.output_col] = st.transform_row(val)
    return frame


def post_clean_conventional(frame: RowFrame, fields: Sequence[str]) -> RowFrame:
    """Algorithm 2 step 14: remove rows that became NULL or empty."""
    return RowFrame([r for r in frame.rows if all(r.get(f) for f in fields)])
