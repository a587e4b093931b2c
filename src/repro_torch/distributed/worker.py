"""Remote shard-executor worker: the actor half of the actor/learner split.

Copy of ``repro/distributed/worker.py``: ``heartbeat_path`` (``:36``),
``run_worker`` (``:40``), ``_serve`` (``:65``) and ``main`` (``:134``). A
worker is a long-lived process (``python -m repro_torch.distributed.worker
--connect HOST:PORT``) that dials the coordinator, receives one pickled
:class:`~repro_torch.core.executor.ShardProgram`, then loops: take a
leased shard task, run it through the same ``ProgramContext`` the process
executor's workers use, and send the packed token and column buffers back
as one ``result`` frame. A daemon thread beats a
:class:`~repro_torch.runtime.fault_tolerance.Heartbeat` file that the
coordinator watches beside the TCP connection, so a wedged-but-connected
worker and a SIGKILLed one both surface.

Where the port differs, as the process executor's worker does
(``repro_torch/core/executor.py:_worker_main``). Under the ``device``
backend the worker binds ``program.device`` before the first shard whose
steps it runs (a shard served from the cache needs no card), and a worker
that sees no card raises: the error reaches the caller as an ``error``
frame and the run fails, with no host fallback. Each ``result`` frame
carries ``launches``, the growth of the text kernels' launch counters
since the worker's last result, which the caller adds to its own. Under a
host backend (``loops``, ``fused``) the worker never imports torch. A
shard's failure is reported as an ``error`` frame; an interrupt or exit
ends the worker instead (the reference reports those too and serves on).
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import sys
import threading
import traceback
from pathlib import Path

import numpy as np

from ..core import executor as EX
from ..runtime.fault_tolerance import Heartbeat
from .transport import recv_frame, send_frame


def heartbeat_path(heartbeat_dir: str | Path, worker_id: str) -> Path:
    return Path(heartbeat_dir) / f"{worker_id}.beat"


def run_worker(
    host: str,
    port: int,
    worker_id: str | None = None,
    *,
    connect_timeout: float = 10.0,
) -> int:
    """Serve one coordinator connection; returns the number of shards done.

    The heartbeat's directory and interval arrive in the ``program``
    frame, so the launch command needs nothing but the coordinator's
    address.
    """
    worker_id = worker_id or f"worker-{socket.gethostname()}-{os.getpid()}"
    sock = socket.create_connection((host, port), timeout=connect_timeout)
    sock.settimeout(None)
    try:
        return _serve(sock, worker_id)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _serve(sock: socket.socket, worker_id: str) -> int:
    send_frame(sock, "hello", {"worker_id": worker_id})
    frame = recv_frame(sock)
    if frame is None:
        return 0
    kind, meta, payload = frame
    if kind != "program":
        raise RuntimeError(f"expected program frame, got {kind!r}")
    program = pickle.loads(bytes(payload))
    ctx = EX.ProgramContext(program, meta.get("cache_dir"))
    program_fp = meta["program_fp"]
    bound: dict = {}  # "counters": the kernels' counters once bound, "mark": as last reported

    def bind() -> None:
        if "counters" not in bound:
            counters = EX._bind_device(program)
            bound.update(counters=counters, mark=dict(counters or {}))

    stop_beating = threading.Event()
    done = 0
    if meta.get("heartbeat_dir"):
        hb = Heartbeat(
            heartbeat_path(meta["heartbeat_dir"], worker_id),
            interval_s=float(meta.get("heartbeat_interval_s", 1.0)),
        )

        def beat_loop() -> None:
            while not stop_beating.is_set():
                try:
                    hb.beat(done, force=True)
                except OSError:
                    pass  # beat dir vanished: the TCP channel still covers us
                stop_beating.wait(hb.interval_s)

        threading.Thread(target=beat_loop, daemon=True).start()

    try:
        while True:
            frame = recv_frame(sock)
            if frame is None:
                break
            kind, meta, payload = frame
            if kind == "shutdown":
                break
            if kind != "task":
                raise RuntimeError(f"unexpected frame kind {kind!r}")
            idx = meta["shard_index"]
            row_take = meta.get("row_take")
            if row_take is not None:
                row_take = np.asarray(row_take, dtype=np.int64)
            try:
                res = ctx.run(
                    bytes(payload) if len(payload) else None,
                    meta.get("path"),
                    meta.get("digest"),
                    row_take,
                    before_steps=bind,
                )
                body, out = EX.pack_shard_result(res, token_space=ctx.token_space)
                counters = bound.get("counters") or {}
                body["launches"] = {k: n - bound["mark"][k] for k, n in counters.items()
                                    if n != bound["mark"][k]}
                if counters:
                    bound["mark"] = dict(counters)
                body["shard_index"] = idx
                body["program_fp"] = program_fp
                send_frame(sock, "result", body, out)
                done += 1
            except (OSError, ConnectionError):
                raise  # the coordinator is gone; no point reporting to it
            except Exception:  # an interrupt ends the worker: its leases go back on EOF
                send_frame(
                    sock,
                    "error",
                    {"shard_index": idx, "traceback": traceback.format_exc()},
                )
    finally:
        stop_beating.set()
    return done


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.distributed.worker",
        description="repro_torch remote shard-executor worker",
    )
    ap.add_argument(
        "--connect",
        required=True,
        metavar="HOST:PORT",
        help="coordinator address to dial",
    )
    ap.add_argument(
        "--worker-id",
        default=None,
        help="stable identity for heartbeat/lease bookkeeping "
        "(default: worker-<host>-<pid>)",
    )
    args = ap.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    run_worker(host or "127.0.0.1", int(port), args.worker_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
