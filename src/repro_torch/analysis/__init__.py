"""Static analysis: plan diagnostics and the port's contract linter.

Copy of ``repro/analysis/__init__.py``. Two halves:

* **Plan analyzer** (:mod:`plan_analyzer`, :mod:`expr_check`,
  :mod:`rewrites`): typed schema inference, expression type checking,
  streaming-shape checks and static verification of every optimizer
  rewrite, surfaced as ``Dataset.validate()`` and run at the head of every
  terminal, so an invalid plan fails with coded, provenance-bearing
  :class:`Diagnostic`\\ s whose codes and severities are the reference's,
  before any executor thread, worker process or remote coordinator starts.
* **Contract linter** (:mod:`contracts`, ``python -m repro_torch.analysis
  --contracts src/repro_torch``): AST and import-graph rules R001–R005 for
  the port's structural invariants (the torch-free worker tier and
  spawn-side byte paths, atomic cache and heartbeat writes, no bare
  excepts in the runtime, a serve hot path free of shard machinery).

This ``__init__`` stays standard-library only: the names resolve lazily
(PEP 562), as in the reference.
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
    "lint_contracts": "contracts",
    "build_import_graph": "contracts",
}

__all__ = ["Diagnostic", "PlanValidationError", "node_ref", *_LAZY]


def __getattr__(name: str):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module("." + submodule, __name__), name)
