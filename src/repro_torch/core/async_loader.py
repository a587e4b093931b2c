"""Async input pipeline: overlap host preprocessing with device compute.

Copy of ``repro/core/async_loader.py``: ``LoaderStats`` (``:34``),
``put_cancellable`` (``:64``), ``drain`` (``:74``), ``ShardPool`` (``:88``)
and ``AsyncLoader`` (``:157``). The paper's motivating problem is the
accelerator idling while the host ingests and preprocesses; the fix is to
preprocess on host threads concurrently with the device step, behind a
bounded prefetch queue.

* ``ShardPool``: work stealing over shard files, so one slow shard never
  blocks the rest of the feed.
* ``AsyncLoader``: bounded prefetch and device double buffering: batch k+1
  is copied to the device before batch k is yielded. Its default transfer
  copies every array leaf to the loader's device (the card unless the
  caller names another); the reference's ``jax.device_put``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ..device import resolve

_SENTINEL = object()


@dataclass
class LoaderStats:
    """Prefetch-queue health counters for one :class:`AsyncLoader`.

    ``starvation`` counts consumer arrivals at an *empty* queue: each one is
    a step where the device would have idled waiting for the host.
    ``max_depth`` is the high-water queue occupancy; ``wait_s`` accumulates
    consumer blocked time as measured by the loader's (injectable) clock.
    """

    prefetch: int = 0
    produced: int = 0
    consumed: int = 0
    starvation: int = 0
    max_depth: int = 0
    wait_s: float = 0.0
    depth: int = 0  # gauge: queue occupancy at the last consumer get

    def as_dict(self) -> dict:
        return dict(
            prefetch=self.prefetch,
            produced=self.produced,
            consumed=self.consumed,
            starvation=self.starvation,
            max_depth=self.max_depth,
            wait_s=self.wait_s,
            depth=self.depth,
        )


def put_cancellable(q: "queue.Queue", item, cancelled: threading.Event) -> None:
    """Bounded put that gives up once the consumer cancelled the feed."""
    while not cancelled.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


def drain(q: "queue.Queue") -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            break


def refuse_sharding(sharding) -> None:
    """The port runs on one card: a sharded transfer waits for the
    multi-device slice (ROADMAP Queue 1, multi-device)."""
    if sharding is not None:
        raise NotImplementedError(
            "sharding= is not supported by the PyTorch port yet: it runs on one "
            "device (multi-device comes last, ROADMAP Queue 1)"
        )


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``device``; to a card through pinned memory and a
    non-blocking copy on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _put_tree(batch, device: torch.device):
    return tree_map(lambda x: to_device(x, device), batch)


class ShardPool:
    """Work-stealing worker pool over an ordered list of work items.

    N reader threads pull items from a shared queue. String/path items are
    normalized to :class:`~pathlib.Path`; everything else passes through
    untouched.
    """

    def __init__(
        self,
        shards: Sequence,
        process_shard: Callable[[Any], Any],
        n_readers: int = 2,
        max_queue: int = 8,
    ):
        self._shards: "queue.Queue[object]" = queue.Queue()
        for s in shards:
            self._shards.put(Path(s) if isinstance(s, (str, Path)) else s)
        self._out: "queue.Queue[object]" = queue.Queue(maxsize=max_queue)
        self._process = process_shard
        self._errors: list[BaseException] = []
        self._stopped = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(n_readers)
        ]
        self._n_live = n_readers
        self._lock = threading.Lock()
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        try:
            while not self._stopped.is_set():
                try:
                    shard = self._shards.get_nowait()
                except queue.Empty:
                    break
                put_cancellable(self._out, self._process(shard), self._stopped)
        except BaseException as e:  # propagate to consumer
            self._errors.append(e)
        finally:
            with self._lock:
                self._n_live -= 1
                last = self._n_live == 0
            if last:
                put_cancellable(self._out, _SENTINEL, self._stopped)

    def stop(self) -> None:
        """Abandon remaining shards and unblock readers; safe to call after
        breaking out of iteration early. Idempotent."""
        self._stopped.set()
        drain(self._shards)
        drain(self._out)
        for t in self._threads:
            t.join(timeout=5.0)

    def __iter__(self) -> Iterator:
        while True:
            item = self._out.get()
            if item is _SENTINEL:
                break
            yield item
        if self._errors:
            raise self._errors[0]


class AsyncLoader:
    """Bounded-prefetch, double-buffered host->device feed.

    ``batches`` is any iterator of (nested dicts, lists or tuples of) numpy
    arrays. The background thread keeps up to ``prefetch`` ready batches;
    consumption copies the next batch to the device while the previous one
    is still computing: batch k is yielded only after batch k+1's copy has
    been issued.

    ``device_put`` replaces the per-leaf copy to ``device`` (tests stub it;
    :class:`~repro_torch.core.device_pipeline.DeviceFeed` passes a host
    no-op and owns the transfer itself); ``device`` is only resolved when
    no ``device_put`` is given. ``clock`` feeds the :class:`LoaderStats`
    wait accounting, so queue starvation is fake-clock testable.
    ``sharding`` is refused.
    """

    def __init__(
        self,
        batches: Iterator,
        prefetch: int = 2,
        sharding=None,
        *,
        device=None,
        device_put: Callable[[Any], Any] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        refuse_sharding(sharding)
        if device_put is None:
            device_put = partial(_put_tree, device=resolve(device))
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=max(prefetch, 1))
        self._device_put = device_put
        self._clock = clock
        self.stats = LoaderStats(prefetch=max(prefetch, 1))
        self._err: list[BaseException] = []
        self._closed = threading.Event()

        def fill() -> None:
            try:
                for b in batches:
                    put_cancellable(self._q, b, self._closed)
                    self.stats.produced += 1
                    self.stats.max_depth = max(self.stats.max_depth, self._q.qsize())
                    if self._closed.is_set():
                        break
            except BaseException as e:
                self._err.append(e)
            finally:
                # Closing the source runs its finalizers; raw executors fed
                # in directly expose stop() instead of close().
                finalize = getattr(batches, "close", None) or getattr(
                    batches, "stop", None
                )
                if finalize is not None:
                    finalize()
                put_cancellable(self._q, _SENTINEL, self._closed)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the fill thread; safe after breaking out of iteration early
        (e.g. a fixed-step loop over an endless epoch stream)."""
        self._closed.set()
        drain(self._q)  # a blocked put() wakes and sees the flag
        self._thread.join(timeout=5.0)

    @property
    def running(self) -> bool:
        """True while the fill thread is alive (close() joins it)."""
        return self._thread.is_alive()

    def _get(self):
        """Dequeue with starvation/wait accounting: an empty queue at
        arrival means the consumer (ultimately the device) would stall."""
        s = self.stats
        s.depth = self._q.qsize()
        starved = s.depth == 0
        if starved:
            s.starvation += 1
        t0 = self._clock()
        item = self._q.get()
        s.wait_s += self._clock() - t0
        if item is _SENTINEL:
            if starved:  # waiting for end-of-stream is not starvation
                s.starvation -= 1
        else:
            s.consumed += 1
        return item

    def __iter__(self) -> Iterator:
        pending = None
        while True:
            item = self._get()
            if item is _SENTINEL:
                break
            device_batch = self._device_put(item)
            if pending is not None:
                yield pending
            pending = device_batch
        if pending is not None:
            yield pending
        if self._err:
            raise self._err[0]
