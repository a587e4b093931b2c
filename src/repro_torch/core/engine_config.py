"""The engine knobs the stage pipeline reads: its byte backend and workers.

Copy of ``repro/core/engine_config.py:69 EngineConfig`` with the two knobs
that ``run_p3sapp`` and ``Pipeline`` read, ``backend`` and ``workers``, and
their resolution (``:106 resolve_workers``, ``:131 resolve_backend``), in
the reference's one order:

    explicit argument  >  field  >  environment variable  >  default

The backend's default is ``device`` (the reference's is ``loops``): the
port's entry points run on the card unless the caller asks for the host
with ``backend="loops"`` or ``"fused"``, or ``device="cpu"``. The executor,
cache and remote knobs come with the ``Dataset`` planner.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import bytesops as B

ENV_WORKERS = "REPRO_WORKERS"
ENV_BACKEND = B.BACKEND_ENV


@dataclass(frozen=True)
class EngineConfig:
    """Explicitly chosen engine options; a field left at ``None`` falls
    through to its environment knob, then to the default."""

    workers: int | None = None
    backend: str | None = None

    def resolve_workers(self, explicit: int | None = None, default: int = 1) -> int:
        if explicit is not None:
            return max(int(explicit), 1)
        if self.workers is not None:
            return max(int(self.workers), 1)
        env = os.environ.get(ENV_WORKERS)
        if env:
            try:
                return max(int(env), 1)
            except ValueError:
                pass
        return default

    def resolve_backend(self, explicit: str | None = None) -> str:
        return B.resolve_backend(explicit or self.backend)
