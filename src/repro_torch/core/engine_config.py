"""One configuration surface for the execution engine.

Copy of ``repro/core/engine_config.py``: ``EngineConfig`` (``:69``) with
its five knobs and their one resolution order:

    explicit argument  >  chain verb (``.workers()/.cache()/.backend()``)
                       >  environment variable  >  default

=======================  =====================================================
``REPRO_EXECUTOR``       shard executor: ``thread``/``process``/``remote``
                         (empty = auto: processes when workers > 1)
``REPRO_WORKERS``        default worker count for every terminal
``REPRO_CACHE``          truthy = enable the on-disk shard cache
``REPRO_CACHE_DIR``      shard-cache root (with ``REPRO_CACHE`` or
                         ``.cache(True)``)
``REPRO_BYTES_BACKEND``  byte backend: ``loops``/``fused``/``device``
=======================  =====================================================

Where the port differs. The backend's default is ``device`` (the
reference's is ``loops``): the port's entry points run on the card unless
the caller asks for the host with ``backend="loops"`` or ``"fused"``, or
``device="cpu"``. The reference's ``REPRO_PALLAS_INTERPRET`` has no counterpart.

This module imports neither torch nor the executor at import time: the
stage pipeline's spawned pool workers and the process shard executor's
spawned children import it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from . import bytesops as B

ENV_EXECUTOR = "REPRO_EXECUTOR"
ENV_WORKERS = "REPRO_WORKERS"
ENV_CACHE = "REPRO_CACHE"
ENV_CACHE_DIR = "REPRO_CACHE_DIR"
ENV_BACKEND = B.BACKEND_ENV

_TRUTHY = ("1", "true", "yes", "on")

# Sentinel distinguishing "no explicit cache choice" (environment decides)
# from an explicit ``.cache(False)`` (stored as None: cache off, env ignored).
_UNSET: Any = object()

EXECUTORS = ("", "thread", "process", "remote")


def _env_truthy(name: str) -> bool:
    """Copy of ``repro/core/engine_config.py:64``."""
    return os.environ.get(name, "").strip().lower() in _TRUTHY


@dataclass(frozen=True)
class EngineConfig:
    """Explicitly chosen engine options; a field left at its default falls
    through to its environment knob, then to the default. Copy of
    ``repro/core/engine_config.py:69``."""

    executor: str | None = None
    workers: int | None = None
    cache_dir: Path | None = _UNSET
    backend: str | None = None
    remote: Any = None

    @classmethod
    def from_options(cls, options: dict[str, Any]) -> "EngineConfig":
        """Build from a ``Dataset`` option dict. ``cache_dir`` is
        tri-state: absent = env decides, None = explicitly off, a path =
        explicitly on."""
        return cls(
            executor=options.get("executor"),
            workers=options.get("workers"),
            cache_dir=options["cache_dir"] if "cache_dir" in options else _UNSET,
            backend=options.get("backend"),
            remote=options.get("remote"),
        )

    # -- resolution (explicit > env > default) -----------------------------
    def resolve_executor(self, explicit: str | None = None) -> str:
        """``""`` means auto (processes when workers > 1, else threads:
        :func:`~repro_torch.core.executor.make_executor` applies that last
        step because it also owns the fallback rules); ``ValueError`` for an
        unknown name."""
        choice = (explicit or self.executor or os.environ.get(ENV_EXECUTOR) or "")
        choice = choice.strip().lower()
        if choice not in EXECUTORS:
            raise ValueError(
                f"unknown executor {choice!r}; use 'thread', 'process' or 'remote'"
            )
        return choice

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

    def resolve_cache_dir(self) -> Path | None:
        """None = shard cache off. Explicit ``.cache(path)`` /
        ``.cache(False)`` beats ``REPRO_CACHE`` (truthy = on, rooted at
        ``REPRO_CACHE_DIR`` or the system temp dir)."""
        if self.cache_dir is not _UNSET:
            return self.cache_dir
        if _env_truthy(ENV_CACHE):
            from .executor import default_cache_dir

            return default_cache_dir()
        return None

    def resolve_backend(self, explicit: str | None = None) -> str:
        return B.resolve_backend(explicit or self.backend)

    def executor_kwargs(
        self, *, workers: int | None = None, default_workers: int = 1
    ) -> dict[str, Any]:
        """The keyword set :func:`repro_torch.core.executor.make_executor`
        takes, fully resolved."""
        return dict(
            workers=self.resolve_workers(workers, default_workers),
            cache_dir=self.resolve_cache_dir(),
            executor=self.executor,
            remote=self.remote,
        )
