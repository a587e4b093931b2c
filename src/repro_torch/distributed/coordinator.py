"""Coordinator for the remote data plane: shard leases, worker liveness,
restart-safe reassignment.

Copy of ``repro/distributed/coordinator.py``: ``LeaseTable`` (``:66``),
``Coordinator`` (``:180``), ``RemoteShardExecutor`` (``:391``) and
``spawn_local_workers`` (``:542``). A pool of worker processes
(:mod:`.worker`) dials the coordinator, which leases shards to whichever
worker asks next (self-scheduling, i.e. work stealing), ships the raw
shard bytes in the task frame, and collects packed token and column
buffers back over the same socket. A shard's products are a pure function
of (shard bytes, program), so fault tolerance is lease bookkeeping:

* every leased shard carries a deadline (:class:`LeaseTable`); an expired
  lease re-enters the pending queue, so a wedged worker's shards are
  stolen by survivors while the original may still finish;
* a dead worker (TCP EOF, or a stale
  :class:`~repro_torch.runtime.fault_tolerance.Heartbeat` file) has its
  in-flight leases released at once;
* results dedup by ``(shard_index, program fingerprint)``: the first
  result under the pair wins and late duplicates are dropped, so
  reassignment never delivers a shard twice.

Killing a worker mid-epoch therefore gives the same batch stream, later.

Where the port differs. Under the ``device`` backend the kernel library is
built here, once, before any worker is spawned, and each worker runs its
scans on ``program.device`` or raises (:mod:`.worker`). The caller adds
each accepted result's ``launches`` to its own counters; a duplicate that
the dedup drops adds nothing, so the count stays one scan per column and
shard after a lease is reassigned. Spawned workers run
``python -m repro_torch.distributed.worker``. ``Coordinator.stop`` shuts
the listening socket down before closing it, which wakes the thread
parked in ``accept``; the reference's waits out that thread's 2 s join.
"""

from __future__ import annotations

import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from ..core import executor as EX
from ..core import ingest as ing
from ..core.async_loader import drain, put_cancellable
from ..runtime.fault_tolerance import Heartbeat
from .transport import TransportError, recv_frame, send_frame
from .worker import heartbeat_path


def _teardown(sock: socket.socket) -> None:
    """Wake any thread blocked on this socket, then close it. A bare
    ``close()`` does not interrupt a concurrent ``recv`` — ``shutdown``
    does."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class LeaseTable:
    """Shard assignment state: pending queue + per-task leases + done set.

    Pure bookkeeping behind one lock, with an injectable ``clock`` so
    lease expiry is unit-testable against a fake clock. A task may hold
    several live leases at once (an expired lease re-enters pending while
    the original worker may still be computing); :meth:`complete` keeps
    exactly the first result. Copy of
    ``repro/distributed/coordinator.py:66``.
    """

    def __init__(
        self,
        n_tasks: int,
        *,
        lease_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.n_tasks = n_tasks
        self.lease_s = lease_s
        self._clock = clock
        self._pending: deque[int] = deque(range(n_tasks))
        self._leases: dict[int, dict[str, float]] = {}
        self._done: set[int] = set()
        self._closed = False
        self._cond = threading.Condition()

    def acquire(self, worker: str, timeout: float | None = None) -> int | None:
        """Lease the next pending task to ``worker``; None when nothing is
        pending within ``timeout`` (or the table closed / all work done)."""
        with self._cond:
            while True:
                while self._pending and self._pending[0] in self._done:
                    self._pending.popleft()  # completed while re-pending
                if self._pending:
                    idx = self._pending.popleft()
                    self._leases.setdefault(idx, {})[worker] = (
                        self._clock() + self.lease_s
                    )
                    return idx
                if self._closed or len(self._done) == self.n_tasks:
                    return None
                if not self._cond.wait(timeout):
                    return None

    def complete(self, idx: int, worker: str | None = None) -> bool:
        """Record a finished task; False when some earlier result already
        won (duplicate delivery after reassignment — drop it)."""
        with self._cond:
            if idx in self._done:
                return False
            self._done.add(idx)
            self._leases.pop(idx, None)
            self._cond.notify_all()
            return True

    def release(self, worker: str) -> list[int]:
        """Drop every lease ``worker`` holds (it died); tasks left with no
        other live lease re-enter the pending queue."""
        with self._cond:
            requeued = []
            for idx in list(self._leases):
                holders = self._leases[idx]
                if worker in holders:
                    del holders[worker]
                    if not holders:
                        del self._leases[idx]
                        if idx not in self._done and idx not in self._pending:
                            self._pending.append(idx)
                            requeued.append(idx)
            if requeued:
                self._cond.notify_all()
            return requeued

    def reap_expired(self) -> list[int]:
        """Re-queue every task whose lease deadline passed (work stealing:
        survivors pick it up; the original may still deliver and lose the
        :meth:`complete` race harmlessly)."""
        now = self._clock()
        with self._cond:
            requeued = []
            for idx, holders in list(self._leases.items()):
                expired = [w for w, dl in holders.items() if dl <= now]
                if not expired:
                    continue
                for w in expired:
                    del holders[w]
                if idx not in self._done and idx not in self._pending:
                    self._pending.append(idx)
                    requeued.append(idx)
                if not holders:
                    del self._leases[idx]
            if requeued:
                self._cond.notify_all()
            return requeued

    def all_done(self) -> bool:
        with self._cond:
            return len(self._done) == self.n_tasks

    def remaining(self) -> int:
        with self._cond:
            return self.n_tasks - len(self._done)

    def leased_to(self, worker: str) -> list[int]:
        with self._cond:
            return [i for i, holders in self._leases.items() if worker in holders]

    def close(self) -> None:
        """Wake every waiter; subsequent acquires return None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class Coordinator:
    """TCP server leasing shards to remote workers and collecting results.

    One handler thread per connected worker: send ``program`` once, then
    loop lease → ``task`` frame (raw shard bytes + digest + survivor rows)
    → ``result`` frame → :meth:`LeaseTable.complete`. A monitor thread
    reaps expired leases and closes the socket of any worker whose
    heartbeat file has gone stale, which funnels every failure mode into
    the handler's exception path: release leases, requeue, survivors
    steal. Copy of ``repro/distributed/coordinator.py:180``; each queued
    result carries the launches its worker reported.
    """

    def __init__(
        self,
        shards: Sequence[str | Path],
        program: EX.ShardProgram,
        *,
        cache_dir: str | Path | None = None,
        row_filters: dict[int, np.ndarray] | None = None,
        lease_s: float = 30.0,
        heartbeat_dir: str | Path | None = None,
        heartbeat_timeout: float = 10.0,
        heartbeat_interval_s: float = 0.5,
        host: str = "127.0.0.1",
        port: int = 0,
        clock: Callable[[], float] = time.monotonic,
        max_buffered: int = 8,
    ):
        self.program = program
        self.program_fp = EX.program_fingerprint(program)
        self.cache_dir = cache_dir
        self.heartbeat_dir = Path(heartbeat_dir) if heartbeat_dir else None
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_interval_s = heartbeat_interval_s
        self._shards = [Path(s) for s in shards]
        self._row_filters = row_filters or {}
        self.leases = LeaseTable(len(self._shards), lease_s=lease_s, clock=clock)
        self.results: "queue.Queue[tuple[str, Any]]" = queue.Queue(
            maxsize=max(max_buffered, 2)
        )
        self._stopped = threading.Event()
        self._conns: dict[str, socket.socket] = {}
        self._conn_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._server = socket.create_server((host, port))
        self.address: tuple[str, int] = self._server.getsockname()[:2]
        for target in (self._accept_loop, self._monitor_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    # -- worker-facing threads ---------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(target=self._handle, args=(sock,), daemon=True)
            t.start()
            self._threads.append(t)

    def _register(self, worker_id: str, sock: socket.socket) -> str:
        with self._conn_lock:
            wid = worker_id
            n = 1
            while wid in self._conns:
                n += 1
                wid = f"{worker_id}#{n}"
            self._conns[wid] = sock
            return wid

    def _handle(self, sock: socket.socket) -> None:
        import pickle

        wid = None
        try:
            sock.settimeout(30.0)  # a silent connection must not park forever
            frame = recv_frame(sock)
            if frame is None or frame[0] != "hello":
                return
            sock.settimeout(None)
            wid = self._register(frame[1].get("worker_id", "worker"), sock)
            send_frame(
                sock,
                "program",
                {
                    "program_fp": self.program_fp,
                    "cache_dir": (
                        str(self.cache_dir) if self.cache_dir is not None else None
                    ),
                    "heartbeat_dir": (
                        str(self.heartbeat_dir) if self.heartbeat_dir else None
                    ),
                    "heartbeat_interval_s": self.heartbeat_interval_s,
                },
                pickle.dumps(self.program, protocol=4),
            )
            self._serve_worker(wid, sock)
        except (OSError, ConnectionError, TransportError, EOFError, pickle.PickleError):
            pass  # worker died / stream broke: leases released below
        finally:
            if wid is not None:
                self.leases.release(wid)
                with self._conn_lock:
                    if self._conns.get(wid) is sock:
                        del self._conns[wid]
            try:
                sock.close()
            except OSError:
                pass

    def _serve_worker(self, wid: str, sock: socket.socket) -> None:
        while not self._stopped.is_set():
            idx = self.leases.acquire(wid, timeout=0.25)
            if idx is None:
                if self.leases.all_done() or self._stopped.is_set():
                    try:
                        send_frame(sock, "shutdown")
                    except OSError:
                        pass
                    return
                continue
            try:
                data, digest = ing.read_shard_bytes(self._shards[idx])
            except OSError as e:
                # A vanished/unreadable shard is a corpus problem, not a
                # worker problem: fail the run instead of churning the
                # lease through every worker forever.
                put_cancellable(
                    self.results,
                    ("err", f"cannot read shard {self._shards[idx]}: {e!r}"),
                    self._stopped,
                )
                return
            send_frame(
                sock,
                "task",
                {
                    "shard_index": idx,
                    "digest": digest,
                    "path": str(self._shards[idx]),
                    "row_take": self._row_filters.get(idx),
                },
                data,
            )
            frame = recv_frame(sock)
            if frame is None:
                raise ConnectionError(f"worker {wid} closed mid-task")
            kind, meta, payload = frame
            if kind == "error":
                put_cancellable(
                    self.results,
                    ("err", f"remote worker {wid} failed:\n{meta['traceback']}"),
                    self._stopped,
                )
                return
            if kind != "result":
                raise TransportError(f"unexpected frame {kind!r} from {wid}")
            ridx = meta["shard_index"]
            if meta.get("program_fp") != self.program_fp:
                continue  # stale result from another program generation
            if not self.leases.complete(ridx, wid):
                continue  # a reassigned copy already delivered this shard
            res = EX.unpack_shard_result(meta, payload)
            res.shard_index = ridx
            put_cancellable(
                self.results, ("ok", (res, meta.get("launches") or {})), self._stopped
            )

    def _monitor_loop(self) -> None:
        while not self._stopped.is_set():
            self.leases.reap_expired()
            if self.heartbeat_dir is not None:
                with self._conn_lock:
                    conns = dict(self._conns)
                for wid, sock in conns.items():
                    ts = Heartbeat.last_beat(heartbeat_path(self.heartbeat_dir, wid))
                    if ts is None:
                        continue  # never beat yet: connection state decides
                    if time.time() - ts > self.heartbeat_timeout:
                        # Wedged worker: tearing its socket down funnels it
                        # into the handler's failure path (release +
                        # requeue). shutdown() — unlike close() — reliably
                        # wakes the handler thread blocked in recv.
                        _teardown(sock)
            self._stopped.wait(min(0.2, self.heartbeat_timeout / 4))

    # -- caller side -------------------------------------------------------
    def worker_count(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self.leases.close()
        _teardown(self._server)  # wakes the accept loop, which close() alone leaves parked
        with self._conn_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock in conns:
            _teardown(sock)
        drain(self.results)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)


class RemoteShardExecutor:
    """Shard executor facade over :class:`Coordinator` + a worker pool.

    Drop-in peer of ``ThreadShardExecutor``/``ProcessShardExecutor``
    (selected via ``executor="remote"`` / ``REPRO_EXECUTOR=remote`` /
    ``Dataset.workers(n, remote=...)``): iterating yields
    :class:`~repro_torch.core.executor.ShardResult` objects with the usual
    counters, and byte-equivalence with the other executors holds because
    workers run the identical compiled program and wire format.

    ``remote`` options (dict, or True/None for defaults):

    * ``spawn`` (default True) — launch ``workers`` local worker processes
      (``python -m repro_torch.distributed.worker``). ``spawn=False`` binds the
      coordinator and waits for externally-launched workers to dial in
      (set ``host``/``port`` to something routable).
    * ``host``/``port`` — coordinator bind address (default loopback,
      ephemeral port).
    * ``lease_s``, ``heartbeat_timeout``, ``heartbeat_interval_s``,
      ``heartbeat_dir`` — liveness tuning (defaults: 30 s leases, 10 s
      heartbeat timeout, per-run temp heartbeat dir).
    * ``python`` — interpreter for spawned workers (default
      ``sys.executable``).

    Copy of ``repro/distributed/coordinator.py:391``; under the ``device``
    backend it builds the kernel library before spawning, and adds each
    consumed result's launches to this process's counters.
    """

    name = "remote"

    def __init__(
        self,
        shards: Sequence[str | Path],
        program: EX.ShardProgram,
        *,
        workers: int = 2,
        cache_dir: str | Path | None = None,
        row_filters: dict[int, np.ndarray] | None = None,
        remote: Any = None,
    ):
        if program.has_dedup:
            raise EX.UnsupportedPlanError(
                "drop_duplicates needs cross-shard state; use the thread executor"
            )
        opts = dict(remote) if isinstance(remote, dict) else {}
        self.program = program
        self.cache_hits = 0
        self.cache_misses = 0
        self.token_cache_hits = 0
        self.token_cache_misses = 0
        self._parse_s = self._pre_s = self._clean_s = self._post_s = 0.0
        self._tokenize_s = 0.0
        self._shards = [Path(s) for s in shards]
        self._stopped = threading.Event()
        self._owns_heartbeat_dir = "heartbeat_dir" not in opts
        heartbeat_dir = opts.get("heartbeat_dir") or tempfile.mkdtemp(
            prefix="repro_torch-heartbeat-"
        )
        self._coord = Coordinator(
            self._shards,
            program,
            cache_dir=cache_dir,
            row_filters=row_filters,
            lease_s=float(opts.get("lease_s", 30.0)),
            heartbeat_dir=heartbeat_dir,
            heartbeat_timeout=float(opts.get("heartbeat_timeout", 10.0)),
            heartbeat_interval_s=float(opts.get("heartbeat_interval_s", 0.5)),
            host=opts.get("host", "127.0.0.1"),
            port=int(opts.get("port", 0)),
            max_buffered=max(2 * workers, 4),
        )
        self.address = self._coord.address
        self.workers: list[subprocess.Popen] = []
        if opts.get("spawn", True):
            if program.backend == "device":
                EX._build_kernels_for(program)
            self.workers = spawn_local_workers(
                self.address,
                max(int(workers), 1),
                python=opts.get("python"),
            )

    def __iter__(self) -> Iterator[EX.ShardResult]:
        consumed = 0
        while consumed < len(self._shards):
            if self._stopped.is_set():
                return
            try:
                status, body = self._coord.results.get(timeout=1.0)
            except queue.Empty:
                try:
                    self._check_liveness()
                except BaseException:
                    self.stop()
                    raise
                continue
            if status == "err":
                self.stop()
                raise RuntimeError(body)
            res, launches = body
            if launches:
                from ..kernels.text_clean import ops as clean_ops

                clean_ops.add_launches(launches)
            self._parse_s += res.parse_s
            self._pre_s += res.pre_clean_s
            self._clean_s += res.clean_s
            self._post_s += res.post_clean_s
            self._tokenize_s += res.tokenize_s
            self.cache_hits += res.cache_hits
            self.cache_misses += res.cache_misses
            self.token_cache_hits += res.token_cache_hits
            self.token_cache_misses += res.token_cache_misses
            consumed += 1
            yield res

    def _check_liveness(self) -> None:
        """Raise when the run can no longer finish: every spawned worker
        exited while shards remain un-done. (A *subset* of workers dying
        is the supported failure mode — their leases re-queue and
        survivors steal the work.)"""
        if self._coord.leases.all_done():
            return
        if self.workers and all(p.poll() is not None for p in self.workers):
            codes = [p.poll() for p in self.workers]
            raise RuntimeError(
                f"all {len(self.workers)} remote shard workers exited "
                f"(codes {codes}) with {self._coord.leases.remaining()} "
                "shards unfinished"
            )

    @property
    def timings(self):
        from ..core.plan import StageTimings

        return StageTimings(
            self._parse_s, self._pre_s, self._clean_s, self._post_s, self._tokenize_s
        )

    def stop(self) -> None:
        """Shut the coordinator and the spawned worker pool down; safe
        after breaking out early. Idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._coord.stop()
        for p in self.workers:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self.workers:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5.0)
        if self._owns_heartbeat_dir and self._coord.heartbeat_dir is not None:
            shutil.rmtree(self._coord.heartbeat_dir, ignore_errors=True)


def spawn_local_workers(
    address: tuple[str, int],
    n: int,
    *,
    python: str | None = None,
) -> list[subprocess.Popen]:
    """Launch ``n`` worker processes on this host dialing ``address``.

    The spawned interpreter sees the same ``repro_torch`` package as the caller
    (its source root is prepended to ``PYTHONPATH``), so an un-installed
    source tree works too. Copy of ``repro/distributed/coordinator.py:542``.
    """
    host, port = address
    src_root = Path(__file__).resolve().parent.parent.parent
    env = dict(os.environ)
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = (
        f"{src_root}{os.pathsep}{existing}" if existing else str(src_root)
    )
    procs = []
    for i in range(n):
        procs.append(
            subprocess.Popen(
                [
                    python or sys.executable,
                    "-m",
                    "repro_torch.distributed.worker",
                    "--connect",
                    f"{host}:{port}",
                    "--worker-id",
                    f"worker-{os.getpid()}-{i}",
                ],
                env=env,
            )
        )
    return procs
