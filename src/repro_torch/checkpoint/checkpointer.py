"""Atomic checkpoints with resume-after-failure semantics.

Copy of ``repro/checkpoint/checkpointer.py:36-161`` (``Checkpointer``), on
the reference's on-disk layout, so that either package restores what the
other wrote:

* **Atomicity**: a checkpoint is written to ``step_{N:010d}.tmp/``, its
  manifest fsynced, and renamed to ``step_{N:010d}/``, the commit point;
  ``steps()`` and ``latest()`` see committed steps only.
* **Layout**: one ``leaf_{i:05d}.npy`` per tensor and ``manifest.json``
  with ``step``, ``time``, ``leaves`` (``path``, ``file``, ``shape``,
  ``dtype``) and ``extra``. Paths are JAX's key paths
  (``tree.flatten_with_paths``: NamedTuple fields by name);
  a bf16 leaf is written as ``np.save`` writes JAX's (2-byte void).
* **Restore** onto a device: leaves are loaded to the host and copied to
  ``device``; with ``shardings`` (a tree of
  ``distributed.sharding.NamedSharding`` of the same structure, None for
  a leaf kept whole on the mesh's device) each rank keeps its block of
  every leaf as a DTensor, the reference's ``shardings``. The mesh may
  differ from the one that saved: that is the elastic path.
* **DTensor leaves** (a model on a mesh) are saved whole: every rank takes
  each leaf's full value (a collective), rank 0 alone writes and commits,
  and every rank waits at a barrier for the commit, so no two ranks race
  on it.
* **Retention**: keep the last ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .tree import flatten_with_paths, map_with_paths, tensor_from_numpy
from ..device import resolve

_MANIFEST = "manifest.json"


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 as its 2-byte pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _snapshot(leaf):
    """A host copy of a leaf that later updates of the leaf cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(leaf, DTensor) for _, leaf in flatten_with_paths(tree))


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: threading.Thread | None = None
        self._async_error: list[BaseException] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> Path:
        final = self.dir / f"step_{step:010d}"
        if _has_dtensor(tree):
            import torch.distributed as dist

            from ..distributed.sharding import full_value

            whole = map_with_paths(lambda _, leaf: full_value(leaf), tree)
            if dist.get_rank() == 0:
                self._write(step, whole, extra)
            dist.barrier()
            return final
        return self._write(step, tree, extra)

    def _write(self, step: int, tree: Any, extra: dict | None) -> Path:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = []
        for i, (path, leaf) in enumerate(flatten_with_paths(tree)):
            arr = _host(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            index.append({"path": path, "file": fname,
                          "shape": list(arr.shape), "dtype": _dtype_name(leaf, arr)})
        manifest = {"step": step, "time": time.time(), "leaves": index, "extra": extra or {}}
        with open(tmp / _MANIFEST, "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit point
        self._gc()
        return final

    # -- async save ----------------------------------------------------------
    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """The device-to-host snapshot happens now (later updates cannot
        change it); the file writes run in a thread. ``wait()`` joins it
        and raises what it raised."""
        self.wait()
        if _has_dtensor(tree):  # the collectives run on every rank, now
            self.save(step, tree, extra)
            return
        host_tree = map_with_paths(lambda _, leaf: _snapshot(leaf), tree)

        def work() -> None:
            try:
                self.save(step, host_tree, extra)
            except BaseException as e:  # surfaced by wait()
                self._async_error.append(e)

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_error:
            raise self._async_error.pop()

    # -- load ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / _MANIFEST).exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Any, step: int | None = None,
                device: str | torch.device | None = None,
                shardings: Any | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``tree_like`` (its leaves only give
        the paths), every leaf a tensor on ``device`` (the card unless the
        caller names another), in the dtype it was saved with. With
        ``shardings`` (same structure) each leaf is a DTensor placed by its
        ``NamedSharding`` (each rank keeps its own block; no collective),
        or, where the sharding is None, a plain tensor on the mesh's
        device."""
        if shardings is not None:
            by_sharding = dict(flatten_with_paths(shardings))
            mesh = next(s.mesh for s in by_sharding.values() if s is not None)
            device = torch.device(mesh.device_type, torch.cuda.current_device()
                                  if mesh.device_type == "cuda" else None)
        device = resolve(device)
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / _MANIFEST).read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}

        def load(path: str, _like) -> torch.Tensor:
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path!r}")
            t = tensor_from_numpy(np.load(d / entry["file"])).to(device)
            if shardings is not None and by_sharding.get(path) is not None:
                from ..distributed.sharding import distribute

                return distribute(t, by_sharding[path])
            return t

        return map_with_paths(load, tree_like), manifest["extra"]

    # -- retention ----------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
