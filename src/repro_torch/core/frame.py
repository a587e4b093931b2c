"""ColumnarFrame — the Spark-DataFrame analogue of this framework.

Copy of ``repro/core/frame.py:1-122`` (the whole file). Columns are NumPy
object arrays of ``str | None``. All frame operations (null drop, dedup,
select, union) are columnar; text transformation happens on flat byte
buffers (:mod:`repro_torch.core.bytesops`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from . import bytesops as B


class ColumnarFrame:
    def __init__(self, columns: Mapping[str, np.ndarray]):
        cols = {k: np.asarray(v, dtype=object) for k, v in columns.items()}
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in cols.items()} }")
        self.columns: dict[str, np.ndarray] = cols
        self._n = lengths.pop() if lengths else 0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_records(cls, records: Sequence[Mapping], fields: Sequence[str]) -> "ColumnarFrame":
        cols = {f: np.array([r.get(f) for r in records], dtype=object) for f in fields}
        return cls(cols)

    @classmethod
    def empty(cls, fields: Sequence[str]) -> "ColumnarFrame":
        return cls({f: np.zeros(0, dtype=object) for f in fields})

    # -- basics --------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    @property
    def field_names(self) -> list[str]:
        return list(self.columns)

    def select(self, fields: Sequence[str]) -> "ColumnarFrame":
        return ColumnarFrame({f: self.columns[f] for f in fields})

    def take(self, mask_or_idx) -> "ColumnarFrame":
        return ColumnarFrame({k: v[mask_or_idx] for k, v in self.columns.items()})

    def union(self, other: "ColumnarFrame") -> "ColumnarFrame":
        """Spark ``DataFrame.union``: cheap columnar concatenation."""
        return ColumnarFrame(
            {k: np.concatenate([v, other.columns[k]]) for k, v in self.columns.items()}
        )

    @staticmethod
    def concat(frames: Sequence["ColumnarFrame"]) -> "ColumnarFrame":
        if not frames:
            raise ValueError("no frames")
        keys = frames[0].field_names
        return ColumnarFrame(
            {k: np.concatenate([f.columns[k] for f in frames]) for k in keys}
        )

    # -- pre-cleaning (paper Algorithm 1 steps 9-10) -------------------------
    def dropna(self, subset: Sequence[str] | None = None) -> "ColumnarFrame":
        subset = subset or self.field_names
        keep = np.ones(self._n, dtype=bool)
        for f in subset:
            col = self.columns[f]
            keep &= np.array([v is not None and v != "" for v in col], dtype=bool)
        return self.take(keep)

    def drop_duplicates(self, subset: Sequence[str] | None = None) -> "ColumnarFrame":
        """Keep-first dedup (deterministic, unlike Spark's dropDuplicates)."""
        subset = subset or self.field_names
        seen: set = set()
        keep = np.ones(self._n, dtype=bool)
        cols = [self.columns[f] for f in subset]
        for i in range(self._n):
            key = tuple(c[i] for c in cols)
            if key in seen:
                keep[i] = False
            else:
                seen.add(key)
        return self.take(keep)

    def ensure_column(self, col: str) -> "ColumnarFrame":
        """Frame with ``col`` present (empty strings when newly created)."""
        if col in self.columns:
            return self
        cols = dict(self.columns)
        cols[col] = np.array([""] * self._n, dtype=object)
        return ColumnarFrame(cols)

    # -- flat-buffer access (pipeline execution) ----------------------------
    def flat(self, col: str) -> np.ndarray:
        vals = ["" if v is None else str(v).replace("\x00", " ") for v in self.columns[col]]
        return B.flatten(vals)

    def with_flat(self, col: str, buf: np.ndarray) -> "ColumnarFrame":
        rows = B.unflatten(buf)
        if len(rows) != self._n:
            raise AssertionError(
                f"row-count invariant violated on column {col!r}: {len(rows)} != {self._n}"
            )
        new_cols = dict(self.columns)
        new_cols[col] = np.array(rows, dtype=object)
        return ColumnarFrame(new_cols)

    # -- boundary conversion (paper Algorithm 1 step 15: toPandas) ----------
    def to_records(self) -> list[dict]:
        keys = self.field_names
        cols = [self.columns[k] for k in keys]
        return [dict(zip(keys, vals)) for vals in zip(*cols)] if self._n else []

    def tokens(self, col: str) -> list[list[str]]:
        """Materialize a whitespace-tokenized view (Spark Tokenizer output)."""
        return [("" if v is None else v).split() for v in self.columns[col]]
