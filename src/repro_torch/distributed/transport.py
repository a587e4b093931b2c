"""Framed socket protocol for the remote data plane.

Copy of ``repro/distributed/transport.py``: ``TransportError`` (``:46``),
``send_frame`` (``:50``) and ``recv_frame`` (``:87``). One frame = a
fixed header (magic + header length + payload length), a pickled
``(kind, meta)`` tuple, and an opaque binary payload. The payload is the
executor wire format of :mod:`repro_torch.core.executor`
(``pack_shard_result``/``unpack_shard_result``), so the bytes that ride a
shared-memory segment under the process executor ride a TCP stream here.

Frame kinds (coordinator <-> worker):

* ``hello``    worker -> coordinator: ``{"worker_id": ...}``
* ``program``  coordinator -> worker: run metadata in ``meta`` (cache dir,
  program fingerprint, heartbeat config); payload = the pickled
  :class:`~repro_torch.core.executor.ShardProgram`
* ``task``     coordinator -> worker: ``{"shard_index", "digest",
  "row_take", "path"}``; payload = raw shard bytes
* ``result``   worker -> coordinator: ``pack_shard_result`` meta +
  ``{"shard_index", "program_fp", "launches"}``; payload = packed buffers
* ``error``    worker -> coordinator: ``{"shard_index", "traceback"}``
* ``shutdown`` coordinator -> worker: no body

The security model is ``multiprocessing``'s (whose queues pickle too):
the protocol is for preprocessing workers you launched on hosts you
control, bound to loopback by default, not for untrusted peers. Standard
library only.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any

MAGIC = b"RSX1"
_HEAD = struct.Struct("!4sQQ")  # magic, pickled-meta length, payload length

# A frame above this size is a protocol error (corrupt or hostile stream),
# not a real shard: refuse instead of trying to allocate it.
MAX_FRAME = 16 << 30


class TransportError(ConnectionError):
    """Malformed frame or broken stream."""


def send_frame(
    sock: socket.socket,
    kind: str,
    meta: dict[str, Any] | None = None,
    payload: bytes | memoryview = b"",
    lock: threading.Lock | None = None,
) -> None:
    """Write one frame; ``lock`` serializes concurrent senders on a shared
    socket (frames must never interleave)."""
    head = pickle.dumps((kind, meta or {}), protocol=4)
    prefix = _HEAD.pack(MAGIC, len(head), len(payload))
    if lock is None:
        sock.sendall(prefix + head)
        if len(payload):
            sock.sendall(payload)
    else:
        with lock:
            sock.sendall(prefix + head)
            if len(payload):
                sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            if got == 0:
                return None
            raise TransportError(f"stream truncated mid-frame ({got}/{n} bytes)")
        got += k
    return buf


def recv_frame(
    sock: socket.socket,
) -> tuple[str, dict[str, Any], memoryview] | None:
    """Read one frame → ``(kind, meta, payload)``; None on clean EOF (the
    peer closed between frames)."""
    head = _recv_exact(sock, _HEAD.size)
    if head is None:
        return None
    magic, head_len, payload_len = _HEAD.unpack(bytes(head))
    if magic != MAGIC:
        raise TransportError(f"bad frame magic {magic!r}")
    if head_len > MAX_FRAME or payload_len > MAX_FRAME:
        raise TransportError(
            f"oversized frame (meta={head_len}, payload={payload_len})"
        )
    meta_raw = _recv_exact(sock, head_len)
    if meta_raw is None:
        raise TransportError("stream truncated before frame meta")
    kind, meta = pickle.loads(bytes(meta_raw))
    if payload_len:
        payload = _recv_exact(sock, payload_len)
        if payload is None:
            raise TransportError("stream truncated before frame payload")
    else:
        payload = bytearray()
    return kind, meta, memoryview(payload)
