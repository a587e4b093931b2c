"""The paper's contribution: the P3SAPP preprocessing pipeline.

Copy of ``repro/core/__init__.py``'s public API:
    Dataset                        — lazy plan: ingestion → batches on the card
    col / lit / concat             — composable column expressions
    abstract_expr / title_expr     — the paper's Fig. 2/3 workflows as expressions
    run_p3sapp / run_conventional  — Algorithm 1 / Algorithm 2 drivers
    Pipeline, stages               — Spark-ML-style transformer chain (deprecated shims)
    ColumnarFrame                  — the DataFrame analogue
    AsyncLoader / ShardPool        — accelerator-overlap input pipeline
    DeviceFeed / OverlapProfiler   — double-buffered handoff to the card with
                                     device-idle accounting

The names resolve lazily (PEP 562): several of their modules import torch,
and the process shard executor's spawned workers and the stage pipeline's
pool workers import modules of this package without it.
"""

_LAZY = {
    "AsyncLoader": "async_loader",
    "LoaderStats": "async_loader",
    "ShardPool": "async_loader",
    "Dataset": "dataset",
    "BucketGrid": "device_pipeline",
    "DeviceBatch": "device_pipeline",
    "DeviceFeed": "device_pipeline",
    "OverlapProfiler": "device_pipeline",
    "OverlapReport": "device_pipeline",
    "abstract_expr": "expr",
    "col": "expr",
    "concat": "expr",
    "lit": "expr",
    "title_expr": "expr",
    "ColumnarFrame": "frame",
    "StageTimings": "p3sapp",
    "case_study_stages": "p3sapp",
    "p3sapp_dataset": "p3sapp",
    "record_match_accuracy": "p3sapp",
    "run_conventional": "p3sapp",
    "run_p3sapp": "p3sapp",
    "Pipeline": "pipeline",
    "PipelineModel": "pipeline",
    "ConvertToLower": "stages",
    "RemoveHTMLTags": "stages",
    "RemoveShortWords": "stages",
    "RemoveUnwantedCharacters": "stages",
    "StopWordsRemover": "stages",
    "Tokenizer": "stages",
    "abstract_stages": "stages",
    "title_stages": "stages",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module("." + submodule, __name__), name)
