"""P3SAPP data ingestion (paper Algorithm 1, steps 1-10).

Copy of ``repro/core/ingest.py``: ``_normalize`` (``:33``),
``_parse_line_iter`` (``:44``), ``_parse_file`` (``:62``), ``parse_shard``
(``:91``), ``list_shards`` (``:97``), ``ingest`` (``:108``) and
``pre_clean`` (``:129``). Every shard file is parsed straight into
columnar buffers with the standard library's ``json`` (the reference's
fallback when ``orjson`` is missing, as it is on the card's machine),
shards are unioned columnar-cheaply, and the pre-cleaning steps (null
drop, dedup) are frame-level operations.

File-level parallelism (Spark partitions == files) is a process pool. Its
workers are spawned, not forked as the reference's: the caller may hold a
CUDA context and threads, which a forked child must not inherit. A worker
imports this module, numpy and the frame (and, as any spawned worker does,
the caller's main module, which must keep its entry point under the
``__main__`` check); it never imports torch.
"""

from __future__ import annotations

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from .frame import ColumnarFrame


def _normalize(value):
    """NUL bytes cannot survive into the columnar engine (ROW_SEP is \\x00):
    normalized once, at ingestion."""
    if isinstance(value, str) and "\x00" in value:
        return value.replace("\x00", " ")
    return value


def _parse_line_iter(lines: Iterable[bytes], fields: Sequence[str]) -> dict[str, list]:
    cols: dict[str, list] = {f: [] for f in fields}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        for f in fields:
            cols[f].append(_normalize(rec.get(f)))
    return cols


def _parse_file(args) -> dict[str, list]:
    path, fields = args
    with open(path, "rb") as fh:
        return _parse_line_iter(fh, fields)


def parse_shard(path: str | Path, fields: Sequence[str]) -> ColumnarFrame:
    """Parse one shard file into a ColumnarFrame."""
    cols = _parse_file((str(path), tuple(fields)))
    return ColumnarFrame({f: np.array(cols[f], dtype=object) for f in fields})


def list_shards(directories: Sequence[str | Path]) -> list[Path]:
    files: list[Path] = []
    for d in directories:
        d = Path(d)
        if d.is_file():
            files.append(d)
        else:
            files.extend(sorted(p for p in d.rglob("*.jsonl") if p.is_file()))
    return files


def ingest(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    workers: int = 1,
) -> ColumnarFrame:
    """Steps 2-8: read every file of every directory, select fields, union."""
    files = list_shards(directories)
    if not files:
        return ColumnarFrame.empty(fields)
    jobs = [(str(p), tuple(fields)) for p in files]
    if workers <= 1:
        parsed = [_parse_file(j) for j in jobs]
    else:
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=spawn) as pool:
            parsed = list(pool.map(_parse_file, jobs))
    frames = [
        ColumnarFrame({f: np.array(c[f], dtype=object) for f in fields}) for c in parsed
    ]
    return ColumnarFrame.concat(frames)


def pre_clean(frame: ColumnarFrame, subset: Sequence[str] | None = None) -> ColumnarFrame:
    """Steps 9-10: remove NULL rows, remove duplicates."""
    return frame.dropna(subset).drop_duplicates(subset)
