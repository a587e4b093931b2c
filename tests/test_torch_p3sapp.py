"""The paper's comparison in the port against the JAX package's:
``run_p3sapp`` (Algorithm 1) under every backend, both executors and 1 or
2 workers, and ``run_conventional`` (Algorithm 2) give the reference's
records byte for byte on a seeded corpus that both packages read, and the
record match (paper Tables 5-6) is the reference's."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import p3sapp as JP
from repro.core.frame import ColumnarFrame as JaxFrame
from repro.core.pipeline import Pipeline as JaxPipeline
from repro.core.stages import ConvertToLower as JaxLower
from repro.core.stages import RemoveShortWords as JaxShort
from repro.data.synthetic import write_corpus
from repro_torch.core import p3sapp as PP
from repro_torch.core.conventional import RowFrame
from repro_torch.core.frame import ColumnarFrame
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.stages import ConvertToLower, RemoveShortWords

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("title", "abstract")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("p3sapp_corpus")
    write_corpus(d, total_bytes=300_000, n_files=3, seed=7)
    return d


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's records: run_p3sapp at both optimize values and
    run_conventional, which must agree among themselves."""
    mp = pytest.MonkeyPatch()
    mp.delenv("REPRO_BYTES_BACKEND", raising=False)
    mp.delenv("REPRO_WORKERS", raising=False)
    try:
        with pytest.warns(DeprecationWarning):
            plain, _ = JP.run_p3sapp([corpus], optimize=False)
            fused, _ = JP.run_p3sapp([corpus], optimize=True)
            ca, t_ca = JP.run_conventional([corpus])
    finally:
        mp.undo()
    assert plain == fused == ca and len(ca) > 50
    return ca, t_ca


@pytest.fixture(autouse=True)
def no_engine_env(monkeypatch):
    monkeypatch.delenv("REPRO_BYTES_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_WORKERS", raising=False)


RUNS = [(b, o, w) for b in ("loops", "fused") for o in (False, True) for w in (1, 2)] + \
    [("device", o, 1) for o in (False, True)]


@pytest.mark.parametrize("backend,optimize,workers", RUNS)
def test_run_p3sapp_gives_the_reference_records(corpus, reference, backend, optimize, workers):
    with pytest.warns(DeprecationWarning):
        records, t = PP.run_p3sapp([corpus], workers=workers, optimize=optimize,
                                   backend=backend, device="cpu")
    assert records == reference[0]
    assert t.tokenize == 0 and min(t.as_dict().values()) >= 0


def test_run_conventional_gives_the_reference_records(corpus, reference):
    with pytest.warns(DeprecationWarning):
        records, t = PP.run_conventional([corpus])
    assert records == reference[0]
    assert t.as_dict().keys() == reference[1].as_dict().keys()


def test_stage_timings_keys_and_sums():
    t = PP.StageTimings(ingestion=1.5, pre_cleaning=0.25, cleaning=2.0, post_cleaning=0.125,
                        tokenize=0.0625)
    ref = JP.StageTimings(ingestion=1.5, pre_cleaning=0.25, cleaning=2.0, post_cleaning=0.125,
                          tokenize=0.0625)
    assert t.as_dict() == ref.as_dict()
    assert t.preprocessing == t.pre_cleaning + t.cleaning + t.post_cleaning + t.tokenize
    assert t.cumulative == t.ingestion + t.preprocessing
    assert list(PP.StageTimings().as_dict()) == list(JP.StageTimings().as_dict())


def test_record_match_accuracy_equals_the_reference(corpus, reference):
    with pytest.warns(DeprecationWarning):
        records, _ = PP.run_p3sapp([corpus], backend="fused")
    ca = reference[0]
    # drop and alter a few records so the match is not trivially 100%
    altered = records[5:] + [{"title": "x", "abstract": "y"}]
    for pa in (records, altered, []):
        for field in FIELDS:
            got = PP.record_match_accuracy(ca, pa, field)
            assert got == JP.record_match_accuracy(ca, pa, field)
    assert PP.record_match_accuracy(ca, records, "abstract")["percentage"] == 100.0


def test_row_frame_append_copies():
    a = RowFrame([{"x": "1"}])
    b = a.append(RowFrame([{"x": "2"}]))
    assert len(a) == 1 and len(b) == 2
    assert b.rows[0] is not a.rows[0] and b.rows[0] == a.rows[0]
    b.rows[0]["x"] = "changed"
    assert a.rows[0] == {"x": "1"}


def test_pipeline_output_col_fork_equals_the_reference():
    """tests/test_pipeline_equivalence.py:46 in both packages."""
    values = np.array(["AA bb", "C dd"], dtype=object)
    with pytest.warns(DeprecationWarning):
        port = Pipeline([ConvertToLower("t", "t_low"), RemoveShortWords("t", threshold=1)])
        ref = JaxPipeline([JaxLower("t", "t_low"), JaxShort("t", threshold=1)])
    frame, jframe = ColumnarFrame({"t": values}), JaxFrame({"t": values})
    want = ref.fit(jframe).transform(jframe)
    for optimize in (False, True):
        got = port.fit(frame).transform(frame, optimize=optimize, backend="fused")
        assert {k: list(v) for k, v in got.columns.items()} == \
            {k: list(v) for k, v in want.columns.items()}
    assert list(got["t_low"]) == ["aa bb", "c dd"]
    assert list(got["t"]) == ["AA bb", "dd"]


def test_run_p3sapp_without_a_card_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PP.run_p3sapp([corpus])
    with pytest.raises(ValueError, match="workers=2"):
        PP.run_p3sapp([corpus], workers=2, device="cpu")


def test_quickstart_example_reports_full_matches():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.warns(DeprecationWarning):
        out = example.main(["--device", "cpu", "--corpus-bytes", "300000"])
    assert out["records"] > 50
    assert out["record_match"] == {"title": 100.0, "abstract": 100.0}
    assert set(out["reductions"]) == {"ingestion", "preprocessing", "cumulative"}


def test_the_pool_task_imports_no_torch():
    """A spawned worker unpickles ``pipeline._run_ops``: importing its module
    must not import torch."""
    code = ("import sys, repro_torch.core.pipeline\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
