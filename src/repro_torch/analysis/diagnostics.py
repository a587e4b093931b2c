"""Structured diagnostics of the plan analyzer.

Copy of ``repro/analysis/diagnostics.py`` (the whole file). Every analysis
failure is a :class:`Diagnostic` with a stable code (``P0xx`` plan shape
and schema, ``E0xx`` expression typing), a human message and provenance
lines rendered like ``Dataset.explain()``'s node listing
(``node 3: Filter(...)``). Error-severity diagnostics raise as
:class:`PlanValidationError` before any executor thread starts.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Diagnostic:
    """One analysis finding with a stable code and provenance.
    Copy of ``repro/analysis/diagnostics.py:22``."""

    code: str  # "P0xx" plan | "E0xx" expression | "R0xx" repo contract
    message: str
    severity: str = "error"  # "error" | "warning"
    provenance: tuple[str, ...] = field(default=())

    def render(self) -> str:
        lines = [f"{self.code} {self.severity}: {self.message}"]
        lines += [f"    at {p}" for p in self.provenance]
        return "\n".join(lines)


def node_ref(index: int, node) -> str:
    """Provenance line for one plan node, in ``explain()``'s listing style.
    Copy of ``repro/analysis/diagnostics.py:36``."""
    return f"node {index}: {node.describe()}"


class PlanValidationError(ValueError):
    """A plan failed static validation.

    Subclasses ``ValueError`` so pre-analyzer call sites that caught the
    old mid-execution raises keep working; carries the structured
    ``diagnostics`` so tools can dispatch on codes instead of matching
    message text.
    Copy of ``repro/analysis/diagnostics.py:41``.
    """

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        body = "\n".join(d.render() for d in self.diagnostics)
        n = len(self.diagnostics)
        super().__init__(
            f"plan failed validation with {n} diagnostic{'s' if n != 1 else ''}:\n{body}"
        )
