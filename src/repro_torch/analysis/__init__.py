"""Static plan analysis: diagnostics before any executor thread starts.

Copy of ``repro/analysis/__init__.py`` without the repo contract linter
(``contracts.py``, a lint over source files that is not on the data path;
ROADMAP Queue 1). Typed schema inference, expression type checking,
streaming-shape checks and static verification of every optimizer rewrite
(:mod:`plan_analyzer`, :mod:`expr_check`, :mod:`rewrites`), surfaced as
``Dataset.validate()`` and run at the head of every terminal, so an
invalid plan fails with coded, provenance-bearing :class:`Diagnostic`\\ s
whose codes and severities are the reference's. The plan-analysis names
resolve lazily (PEP 562), as in the reference.
"""

from .diagnostics import Diagnostic, PlanValidationError, node_ref

_LAZY = {
    "analyze_plan": "plan_analyzer",
    "infer_schema": "plan_analyzer",
    "check_streaming_plan": "plan_analyzer",
    "check_row_program_plan": "plan_analyzer",
    "check_transform": "expr_check",
    "check_predicate": "expr_check",
    "verify_plan_rewrites": "rewrites",
    "verify_rewrite_pair": "rewrites",
}

__all__ = ["Diagnostic", "PlanValidationError", "node_ref", *_LAZY]


def __getattr__(name: str):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module("." + submodule, __name__), name)
