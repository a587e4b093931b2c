"""P3SAPP and CA entry points: the paper's comparison (Algorithms 1 and 2).

Copy of ``repro/core/p3sapp.py``: ``case_study_stages`` (``:51``),
``run_conventional`` (``:88``) and ``record_match_accuracy`` (``:115``),
with ``StageTimings`` from ``repro/core/plan.py:62-90``.

``run_p3sapp`` takes Algorithm 1's literal shape, where the reference
builds a ``Dataset`` plan (the planner is not ported yet):

    ingest -> dropna -> drop_duplicates -> Pipeline(stages) -> dropna -> records

Its steps 11-14 are the Spark-ML ``Pipeline`` of
:mod:`repro_torch.core.pipeline`, which the reference documents as giving
the planner's ``Project`` path byte for byte. With the ``device`` backend
(the default) each column's scan pass runs on the card's ``text_scan``
kernel; the rest of the chain runs on the host, as in the reference.

Timing attribution follows §3 of the paper, as the reference's planner
attributes it (``repro/core/plan.py:734-770``,
``repro/core/dataset.py:742-760``):

=============  =======================  =======================
stage          P3SAPP (Algorithm 1)     CA (Algorithm 2)
=============  =======================  =======================
ingestion      steps 2-8                steps 2-8
pre-cleaning   steps 9-10               steps 9-10
cleaning       steps 11-14 (pipeline)   steps 11-13 (row loop)
post-cleaning  steps 15-16 (toPandas)   step 14
=============  =======================  =======================

``preprocessing = pre_cleaning + cleaning + post_cleaning + tokenize`` and
``cumulative = ingestion + preprocessing`` (paper eq. 7); ``tokenize``
stays 0 here, as it does in the reference's ``run_p3sapp``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

from ..device import resolve
from . import conventional as ca
from .engine_config import EngineConfig
from .ingest import ingest
from .pipeline import Pipeline, check_workers
from .stages import Stage, abstract_stages, title_stages

__all__ = [
    "StageTimings",
    "case_study_stages",
    "record_match_accuracy",
    "run_conventional",
    "run_p3sapp",
]


@dataclass
class StageTimings:
    """Paper §3 timing attribution (eq. 7), with the reference's token
    step (``repro/core/plan.py:62``)."""

    ingestion: float = 0.0
    pre_cleaning: float = 0.0
    cleaning: float = 0.0
    post_cleaning: float = 0.0
    tokenize: float = 0.0

    @property
    def preprocessing(self) -> float:
        return self.pre_cleaning + self.cleaning + self.post_cleaning + self.tokenize

    @property
    def cumulative(self) -> float:
        return self.ingestion + self.preprocessing

    def as_dict(self) -> dict:
        return {
            "ingestion": self.ingestion,
            "pre_cleaning": self.pre_cleaning,
            "cleaning": self.cleaning,
            "post_cleaning": self.post_cleaning,
            "tokenize": self.tokenize,
            "preprocessing": self.preprocessing,
            "cumulative": self.cumulative,
        }


def case_study_stages(abstract_col: str = "abstract", title_col: str = "title") -> list[Stage]:
    """Paper Fig. 2 and Fig. 3 workflows chained into one pipeline."""
    return abstract_stages(abstract_col) + title_stages(title_col)


def run_p3sapp(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    stages: Sequence[Stage] | None = None,
    workers: int | None = None,
    optimize: bool = False,
    backend: str | None = None,
    device=None,
) -> tuple[list[dict], StageTimings]:
    """Algorithm 1. Returns (records, timings).

    ``optimize=False`` runs each stage's ops in turn (the paper's
    executor); ``optimize=True`` fuses each column's ops first. ``backend``
    is ``device`` (the default, or ``REPRO_BYTES_BACKEND``), ``fused`` or
    ``loops``; under ``device`` the scan passes run on ``device``, the card
    unless the caller names another, and without a card this raises.
    ``workers`` (default ``REPRO_WORKERS``, else 1) parse shards and, on a
    host backend, clean row chunks in spawned processes.
    """
    cfg = EngineConfig(workers=workers, backend=backend)
    backend, workers = cfg.resolve_backend(), cfg.resolve_workers()
    check_workers(backend, workers)
    if backend == "device":
        device = resolve(device)
    fields = list(fields)
    stages = list(stages) if stages is not None else case_study_stages()
    t = StageTimings()

    t0 = time.perf_counter()
    frame = ingest(directories, fields, workers=workers)  # steps 2-8
    t.ingestion = time.perf_counter() - t0

    t0 = time.perf_counter()
    frame = frame.dropna(fields).drop_duplicates(fields)  # steps 9-10
    t.pre_cleaning = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = Pipeline(stages).fit(frame)  # steps 11-13
    frame = model.transform(frame, workers, optimize, backend, device)  # step 14
    t.cleaning = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = frame.dropna(fields).to_records()  # steps 15-16
    t.post_cleaning = time.perf_counter() - t0
    return records, t


def run_conventional(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    stages: Sequence[Stage] | None = None,
) -> tuple[list[dict], StageTimings]:
    """Algorithm 2. Returns (records, timings)."""
    t = StageTimings()
    stages = list(stages) if stages is not None else case_study_stages()

    t0 = time.perf_counter()
    frame = ca.ingest_conventional(directories, fields)  # steps 2-8
    t.ingestion = time.perf_counter() - t0

    t0 = time.perf_counter()
    frame = ca.pre_clean_conventional(frame, fields)  # steps 9-10
    t.pre_cleaning = time.perf_counter() - t0

    t0 = time.perf_counter()
    frame = ca.clean_conventional(frame, stages)  # steps 11-13
    t.cleaning = time.perf_counter() - t0

    t0 = time.perf_counter()
    frame = ca.post_clean_conventional(frame, fields)  # step 14
    t.post_cleaning = time.perf_counter() - t0
    return frame.rows, t


def record_match_accuracy(
    ca_records: list[dict], pa_records: list[dict], field: str
) -> dict:
    """Paper §5.2: percentage of matching records between the two frames."""
    ca_vals = [r.get(field) for r in ca_records]
    pa_vals = set(r.get(field) for r in pa_records)
    matching = sum(1 for v in ca_vals if v in pa_vals)
    denom = max(len(ca_records), 1)
    return {
        "conventional": len(ca_records),
        "proposed": len(pa_records),
        "matching": matching,
        "percentage": 100.0 * matching / denom,
    }
