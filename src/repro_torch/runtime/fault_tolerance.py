"""Checkpointed training control: resume from the last committed step.

Copy of ``repro/runtime/fault_tolerance.py``: ``Heartbeat`` (``:33-75``)
and ``TrainController`` (``:78-131``). The controller resumes on
construction from the latest committed checkpoint, with ``init_state`` as
the donor of the tree's structure, and restores onto the device of the
parameters ``init_state`` makes (the model's). ``run`` beats the
heartbeat, records each step's metrics as floats, saves every
``save_every`` steps and once at the end. ``shardings`` (a tree of
``NamedSharding`` of the ``(params, opt_state)`` structure, None for a leaf
kept whole) restores onto a mesh, as the reference's does; the saves of a
tree of DTensors write whole tensors from rank 0 (``Checkpointer.save``).

The remote data plane's workers import ``Heartbeat`` from here, and under
a host backend they never import torch: so this module imports torch and
the checkpointer only inside the functions that use them (the contract
lint's rule R001).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Iterator


class Heartbeat:
    """Liveness beacon file: ``<step> <unix-time>``.

    Writes go to a temp file in the same directory and are atomically
    renamed into place, so a monitor (``is_alive``) never observes a torn,
    partially written beat: a reader sees the previous beat or the new one.
    """

    def __init__(self, path: str | Path, interval_s: float = 5.0):
        self.path = Path(path)
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int, *, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.interval_s:
            return
        tmp = self.path.with_name(self.path.name + f".tmp{os.getpid()}")
        tmp.write_text(f"{step} {now}")
        os.replace(tmp, self.path)
        self._last = now

    @staticmethod
    def last_beat(path: str | Path) -> float | None:
        """Unix time of the last committed beat, or None when the file is
        missing or unreadable (never raises: a vanished or garbage file
        means "no beat")."""
        try:
            _, ts = Path(path).read_text().split()
            return float(ts)
        except (OSError, ValueError):
            # OSError: missing or unreadable. ValueError: garbage content;
            # with atomic beats that is corruption, not a torn write.
            return None

    @staticmethod
    def is_alive(path: str | Path, timeout_s: float) -> bool:
        ts = Heartbeat.last_beat(path)
        return ts is not None and (time.time() - ts) < timeout_s


def _device_of(tree: Any) -> "torch.device":
    import torch

    from ..checkpoint.tree import flatten_with_paths

    for _, leaf in flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("init_state() made no tensor to take a device from")


class TrainController:
    """Checkpointed step loop: resumes from the latest committed step."""

    def __init__(
        self,
        ckpt_dir: str | Path,
        train_step: Callable,  # (params, opt_state, batch) -> (params, opt, metrics)
        init_state: Callable[[], tuple[Any, Any]],  # () -> (params, opt_state)
        *,
        save_every: int = 50,
        keep: int = 3,
        shardings: Any | None = None,
        heartbeat: Heartbeat | None = None,
    ):
        from ..checkpoint.checkpointer import Checkpointer

        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.train_step = train_step
        self.save_every = save_every
        self.heartbeat = heartbeat
        self.shardings = shardings

        params, opt_state = init_state()  # the start, or the structure donor
        latest = self.ckpt.latest()
        if latest is None:
            self.params, self.opt_state = params, opt_state
            self.step = 0
            self.resumed = False
        else:
            (self.params, self.opt_state), extra = self.ckpt.restore(
                (params, opt_state), latest,
                device=None if shardings is not None else _device_of(params),
                shardings=shardings)
            self.step = int(extra.get("step", latest))
            self.resumed = True

    def run(self, batches: Iterator, n_steps: int) -> list[dict]:
        history = []
        for batch in batches:
            if self.step >= n_steps:
                break
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            self.step += 1
            if self.heartbeat is not None:
                self.heartbeat.beat(self.step)
            history.append({"step": self.step, **{k: float(v) for k, v in metrics.items()}})
            if self.step % self.save_every == 0:
                self.save()
        self.save()
        return history

    def save(self) -> None:
        self.ckpt.save(self.step, (self.params, self.opt_state), extra={"step": self.step})
