"""Host->device overlap engine and the on-device cleaning engine.

Copy of ``repro/core/device_pipeline.py``: ``BucketGrid`` (``:45``),
``DeviceBatch`` (``:120``), ``OverlapReport`` (``:166``),
``OverlapProfiler`` (``:192``), ``DeviceFeed`` (``:238``),
``DeviceCleaner`` (``:359``) and ``device_case_study_cleaner`` (``:399``).

The paper's framing: the accelerator idles while the host preprocesses
text. :class:`DeviceFeed` takes host token batches, snaps every batch onto
a fixed bucket grid (rows padded to the batch size, each bucketed column to
its grid rung) and copies it to the card double-buffered: batch k+1's copy
is issued, on a side stream from pinned memory, before batch k is yielded.
The consumer's stream waits on an event recorded after the copy, and each
tensor is marked as used by that stream. PyTorch has no buffer donation;
the reference's guard stays: :meth:`DeviceFeed.step` marks the batch
consumed on exit, and any later read raises. :class:`OverlapProfiler`
accounts host-wait against device-step time and reports the device-idle
fraction, the paper's claim measured.

:class:`DeviceCleaner` runs the character cleaning (lowercase, HTML span,
letters only) as the ``text_clean`` kernel on the card and a ``col()``
word chain on the host. Where the reference takes ``interpret=``, it takes
a device: the card unless the caller names another.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from ..data.tokenizer import PAD
from ..device import resolve
from ..kernels.text_clean.ops import clean_flat
from . import bytesops as B
from . import expr as E
from .async_loader import AsyncLoader, LoaderStats, put_sharded, to_device

# ---------------------------------------------------------------------------
# Fixed bucket grid: the closed shape set of the device step
# ---------------------------------------------------------------------------


class BucketGrid:
    """The static shape contract between batch assembly and the device step.

    ``widths`` maps each bucketed array column to its ladder of bucket
    widths (ascending). :meth:`snap` pads a host batch onto the grid: rows
    up to ``batch_size`` (PAD rows), each laddered column up to the
    smallest rung that fits. Every snapped batch then has one of
    ``n_cells`` shapes.
    """

    def __init__(self, batch_size: int, widths: Mapping[str, Sequence[int]]):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = int(batch_size)
        self.widths = {
            c: tuple(sorted(int(w) for w in ws)) for c, ws in widths.items()
        }
        for c, ws in self.widths.items():
            if not ws:
                raise ValueError(f"empty bucket ladder for column {c!r}")

    @property
    def n_cells(self) -> int:
        n = 1
        for ws in self.widths.values():
            n *= len(ws)
        return n

    def _rung(self, column: str, width: int) -> int:
        ladder = self.widths[column]
        for w in ladder:
            if width <= w:
                return w
        raise ValueError(
            f"column {column!r} is {width} wide, beyond the top bucket "
            f"{ladder[-1]} — the batch was not assembled on this grid"
        )

    def snap(self, batch: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Pad ``batch`` onto the grid (prefix-preserving, PAD fill)."""
        out: dict[str, np.ndarray] = {}
        for k, v in batch.items():
            v = np.asarray(v)
            rows = v.shape[0]
            width = v.shape[1] if v.ndim > 1 else None
            target_w = (
                self._rung(k, width)
                if width is not None and k in self.widths
                else width
            )
            if rows == self.batch_size and (width is None or target_w == width):
                out[k] = v
                continue
            shape = (self.batch_size,) + (
                (target_w,) + v.shape[2:] if width is not None else v.shape[1:]
            )
            padded = np.full(shape, PAD, dtype=v.dtype)
            if width is None:
                padded[:rows] = v
            else:
                padded[:rows, :width] = v
            out[k] = padded
        return out

    def cell_key(self, batch: Mapping[str, Any]) -> tuple:
        """Hashable static-shape key of a (snapped) batch."""
        return tuple(sorted((k, tuple(np.shape(v))) for k, v in batch.items()))


# ---------------------------------------------------------------------------
# Device batches with the reuse-after-consume guard
# ---------------------------------------------------------------------------


class DeviceBatch(Mapping):
    """One grid-snapped batch on the device.

    A read-only mapping of tensors. ``ready`` is the event recorded on the
    copy stream after the batch's copies to ``device`` (None when there is
    none to wait for). Once the consuming step is over
    (:meth:`mark_donated`, done by ``DeviceFeed.step(...)`` on exit), any
    further access raises.
    """

    def __init__(self, arrays: dict[str, Any], cell: tuple,
                 ready: torch.cuda.Event | None = None, device: torch.device | None = None):
        self._arrays = arrays
        self.cell = cell
        self.donated = False
        self._ready = ready
        self._device = device

    def hand_over(self) -> None:
        """Make the current stream wait for the batch's copies and mark each
        tensor as used by that stream, so its memory is not reused before
        the stream's work on it is done."""
        if self._ready is None:
            return
        from torch.distributed.tensor import DTensor

        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(self._ready)
        for t in self._arrays.values():
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)
        self._ready = None

    def mark_donated(self) -> None:
        self.donated = True

    def _check(self) -> None:
        if self.donated:
            raise RuntimeError(
                "reuse after donate: this DeviceBatch was consumed by a device "
                "step; its buffers may be reused now"
            )

    @property
    def arrays(self) -> dict[str, Any]:
        self._check()
        return self._arrays

    def __getitem__(self, key: str):
        self._check()
        return self._arrays[key]

    def __iter__(self):
        return iter(self._arrays)

    def __len__(self) -> int:
        return len(self._arrays)


# ---------------------------------------------------------------------------
# Overlap accounting
# ---------------------------------------------------------------------------


@dataclass
class OverlapReport:
    """Per-epoch overlap accounting (all times from the profiler clock).

    ``device_idle_fraction`` is steady-state: the first-batch pipeline fill
    (``startup_s``) is reported separately and excluded from the fraction.
    """

    steps: int = 0
    host_wait_s: float = 0.0  # post-startup consumer stalls (device idle)
    startup_s: float = 0.0  # first-batch pipeline fill
    device_s: float = 0.0  # time inside profiled device steps
    transfer_s: float = 0.0  # host->device copies issued by the feed
    starved_steps: int = 0  # steps that waited > eps on the host

    @property
    def device_idle_fraction(self) -> float:
        busy = self.host_wait_s + self.device_s
        return self.host_wait_s / busy if busy > 0 else 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["device_idle_fraction"] = self.device_idle_fraction
        return d


class OverlapProfiler:
    """Accumulates host-wait vs device-compute time for one feed epoch.

    The clock is injectable, so the idle-fraction math is exactly testable
    against a fake clock; ``starvation_eps`` separates true stalls from the
    microseconds a warm queue handoff costs on a real clock.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        starvation_eps: float = 1e-3,
    ):
        self.clock = clock
        self.starvation_eps = starvation_eps
        self._r = OverlapReport()

    def record_wait(self, dt: float, startup: bool = False) -> None:
        if startup:
            self._r.startup_s += dt
            return
        self._r.host_wait_s += dt
        if dt > self.starvation_eps:
            self._r.starved_steps += 1

    def record_transfer(self, dt: float) -> None:
        self._r.transfer_s += dt

    @contextmanager
    def step(self):
        """Time one device-compute segment (the caller synchronizes inside
        the ``with`` for honest accounting)."""
        t0 = self.clock()
        yield
        self._r.device_s += self.clock() - t0
        self._r.steps += 1

    def report(self) -> OverlapReport:
        return self._r


# ---------------------------------------------------------------------------
# The feed
# ---------------------------------------------------------------------------


class DeviceFeed:
    """Double-buffered host->device handoff with idle accounting.

    ``batches`` is an iterator of host dict-batches of numpy arrays. With
    ``prefetch >= 1`` an :class:`~repro_torch.core.async_loader.AsyncLoader`
    in host mode runs the upstream pipeline in a fill thread (its
    :class:`LoaderStats` expose queue depth and starvation); ``prefetch=0``
    pulls synchronously (no threads: exact fake-clock semantics for tests).

    Iteration yields :class:`DeviceBatch` objects one transfer ahead: batch
    k+1 is already in flight when batch k is handed to the step. Wrap each
    step in :meth:`step`: it times the step and, with ``donate=True``,
    marks the batch consumed. Batches go to ``device`` (the card unless the
    caller names another) unless ``device_put`` replaces the per-array
    copy. With ``sharding`` (a ``distributed.sharding.NamedSharding``) each
    rank copies only its own block of every array, through the same pinned
    path and copy stream, and the batch holds DTensors of the global shape.
    """

    def __init__(
        self,
        batches: Iterator,
        *,
        grid: BucketGrid | None = None,
        prefetch: int = 2,
        sharding: Any = None,
        donate: bool = True,
        device=None,
        device_put: Callable[[np.ndarray], Any] | None = None,
        clock: Callable[[], float] = time.perf_counter,
        profiler: OverlapProfiler | None = None,
    ):
        self.grid = grid
        self.sharding = sharding
        self.donate = donate
        self._device_put = device_put
        self.device = None if device_put is not None else resolve(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device is not None and self.device.type == "cuda" else None)
        self._clock = clock
        self.profiler = profiler or OverlapProfiler(clock=clock)
        self._loader: AsyncLoader | None = None
        if prefetch >= 1:
            self._loader = AsyncLoader(
                batches,
                prefetch=prefetch,
                device_put=lambda b: b,  # host prefetch only; the feed copies
                clock=clock,
            )
            self._source: Iterator = iter(self._loader)
        else:
            self._source = iter(batches)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._loader is not None:
            self._loader.close()
        else:
            finalize = getattr(self._source, "close", None)
            if finalize is not None:
                finalize()

    @property
    def loader_stats(self) -> LoaderStats | None:
        """Queue gauges of the host prefetch stage (None when prefetch=0)."""
        return self._loader.stats if self._loader is not None else None

    # -- transfer ----------------------------------------------------------
    def _transfer(self, host_batch: Mapping[str, np.ndarray]) -> DeviceBatch:
        snapped = self.grid.snap(host_batch) if self.grid is not None else host_batch
        cell = (
            self.grid.cell_key(snapped)
            if self.grid is not None
            else tuple(sorted((k, np.shape(v)) for k, v in snapped.items()))
        )
        t0 = self._clock()
        ready = None
        if self._device_put is not None or self._copy_stream is None:
            arrays = {k: self._put(v) for k, v in snapped.items()}
        else:
            with torch.cuda.stream(self._copy_stream):
                arrays = {k: self._put(v) for k, v in snapped.items()}
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        self.profiler.record_transfer(self._clock() - t0)
        return DeviceBatch(arrays, cell, ready, self.device)

    def _put(self, v) -> Any:
        """One array to the device (by ``device_put`` where the caller gave
        one): the whole array, or this rank's block as a DTensor under
        ``sharding``."""
        if self.sharding is not None:
            return put_sharded(v, self.sharding, self.device, self._device_put)
        if self._device_put is not None:
            return self._device_put(np.asarray(v))
        return to_device(np.asarray(v), self.device)

    # -- consumption -------------------------------------------------------
    def __iter__(self) -> Iterator[DeviceBatch]:
        pending: DeviceBatch | None = None
        first = True
        while True:
            t0 = self._clock()
            try:
                host = next(self._source)
            except StopIteration:
                break
            self.profiler.record_wait(self._clock() - t0, startup=first)
            first = False
            nxt = self._transfer(host)
            if pending is not None:
                pending.hand_over()
                yield pending
            pending = nxt
        if pending is not None:
            pending.hand_over()
            yield pending

    @contextmanager
    def step(self, batch: DeviceBatch | None = None):
        """Time one device step; with ``donate=True`` the batch is marked
        consumed on exit."""
        with self.profiler.step():
            yield
        if batch is not None and self.donate:
            batch.mark_donated()

    def report(self) -> OverlapReport:
        return self.profiler.report()


# ---------------------------------------------------------------------------
# On-device cleaning
# ---------------------------------------------------------------------------


class DeviceCleaner:
    """Cleaning engine: character stages on the device, word stages on the
    host. Equivalent to ``lower + strip_html + keep_letters`` character
    classes (no contraction mapping: contractions lose their apostrophes
    instead of expanding, as in the reference). The host half is a
    ``col()`` chain (word-level verbs only), compiled once and applied to
    the flat byte buffer the device pass returns.

    ``seconds`` accumulates the wall time of the two halves over
    :meth:`transform` calls: ``device_clean`` (pack, copy, kernel, copy
    back, collapse) and ``word_tail``.
    """

    def __init__(self, word_expr: Callable | None = None, device=None):
        self.device = resolve(device)
        self.seconds = {"device_clean": 0.0, "word_tail": 0.0}
        if word_expr is None:
            self._ops: tuple = ()
        else:
            kind, source, ops = E.compile_expr(word_expr(E.col("__device_cleaned")))
            if kind != "chain" or source != "__device_cleaned":
                raise ValueError(
                    "word_expr must be a pure per-column chain "
                    "(Expr -> Expr over its input column)"
                )
            self._ops = tuple(ops)

    def transform(self, frame, cols: list[str]):
        out = frame
        for c in cols:
            t0 = time.perf_counter()
            rows = ["" if v is None else str(v) for v in out[c]]
            buf = clean_flat(rows, device=self.device)
            t1 = time.perf_counter()
            if self._ops:
                buf = B.apply_ops(buf, list(self._ops))
            self.seconds["device_clean"] += t1 - t0
            self.seconds["word_tail"] += time.perf_counter() - t1
            out = out.with_flat(c, buf)
        return out


def device_case_study_cleaner(device=None) -> DeviceCleaner:
    """The case-study word tail (stopwords + short words) over the device
    character pass."""
    return DeviceCleaner(
        word_expr=lambda e: e.remove_stopwords().min_word_len(2),
        device=device,
    )
