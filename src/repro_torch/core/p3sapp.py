"""P3SAPP and CA entry points: the paper's comparison (Algorithms 1 and 2).

Copy of ``repro/core/p3sapp.py``: ``case_study_stages`` (``:51``),
``p3sapp_dataset`` (``:56``), ``run_p3sapp`` (``:72``),
``run_conventional`` (``:88``) and ``record_match_accuracy`` (``:115``);
``StageTimings`` is re-exported from its home, the planner
(``repro_torch.core.plan``), as in the reference.

``run_p3sapp`` is one declarative plan, the canonical chain

    Dataset.from_json_dirs -> dropna -> drop_duplicates -> apply(stages) -> dropna

executed whole-frame by the planner with the paper's stage timings.
``optimize=False`` is the paper's executor (each stage's ops one by one);
``optimize=True`` merges each column's stages and fuses their ops. With the
``device`` backend (the default) every scan pass that the ``text_scan``
kernel computes runs on the card; the rest of the chain runs on the host,
as in the reference.

Timing attribution follows §3 of the paper:

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
from pathlib import Path
from typing import Sequence

from ..device import resolve
from . import conventional as ca
from .dataset import Dataset
from .engine_config import EngineConfig
from .pipeline import check_workers
from .plan import StageTimings  # re-exported; canonical home is the planner
from .stages import Stage, abstract_stages, title_stages

__all__ = [
    "StageTimings",
    "case_study_stages",
    "p3sapp_dataset",
    "record_match_accuracy",
    "run_conventional",
    "run_p3sapp",
]


def case_study_stages(abstract_col: str = "abstract", title_col: str = "title") -> list[Stage]:
    """Paper Fig. 2 and Fig. 3 workflows chained into one pipeline.
    Copy of ``repro/core/p3sapp.py:51``."""
    return abstract_stages(abstract_col) + title_stages(title_col)


def p3sapp_dataset(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    stages: Sequence[Stage] | None = None,
) -> Dataset:
    """The canonical Algorithm 1 chain as a lazy Dataset plan.
    Copy of ``repro/core/p3sapp.py:56``."""
    stages = list(stages) if stages is not None else case_study_stages()
    return (
        Dataset.from_json_dirs(directories, fields)  # steps 2-8
        .dropna(fields)  # step 9
        .drop_duplicates(fields)  # step 10
        .apply(*stages)  # steps 11-14
        .dropna(fields)  # step 16
    )


def run_p3sapp(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    stages: Sequence[Stage] | None = None,
    workers: int | None = None,
    optimize: bool = False,
    backend: str | None = None,
    device=None,
) -> tuple[list[dict], StageTimings]:
    """Algorithm 1: ``p3sapp_dataset(...).execute()``. Returns (records,
    timings).

    ``optimize=False`` is the paper's executor; ``optimize=True`` the
    planned and fused one. ``backend`` is ``device`` (the default, or
    ``REPRO_BYTES_BACKEND``), ``fused`` or ``loops``; under ``device`` the
    scan passes run on ``device``, the card unless the caller names
    another, and without a card this raises. ``workers`` (default
    ``REPRO_WORKERS``, else 1) parse shards and, on a host backend, clean
    row chunks in spawned processes; the ``device`` backend refuses
    ``workers > 1``.
    Copy of ``repro/core/p3sapp.py:72``.
    """
    cfg = EngineConfig(workers=workers, backend=backend)
    backend, workers = cfg.resolve_backend(), cfg.resolve_workers()
    check_workers(backend, workers)
    if backend == "device":
        device = resolve(device)
    ds = p3sapp_dataset(directories, fields, stages).backend(backend)
    return ds.execute(workers=workers, optimize=optimize, device=device)


def run_conventional(
    directories: Sequence[str | Path],
    fields: Sequence[str] = ("title", "abstract"),
    stages: Sequence[Stage] | None = None,
) -> tuple[list[dict], StageTimings]:
    """Algorithm 2. Returns (records, timings). Copy of ``repro/core/p3sapp.py:88``."""
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
    """Paper §5.2: percentage of matching records between the two frames.
    Copy of ``repro/core/p3sapp.py:115``."""
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
