"""Shard executors: reader threads or spawned worker processes, and the
plan-fingerprint shard cache.

Copy of ``repro/core/executor.py`` (``:78-1906``); its remote executor is
:mod:`repro_torch.distributed.coordinator`, which :func:`make_executor`
selects:

* :class:`ShardProgram`: the per-shard physical program compiled from the
  frame-level plan (parse -> select/dropna/filter[/dedup] -> per-column
  compiled expressions -> token encoding or word counting). ``filter``
  steps evaluate predicates to row masks straight off the flat buffers.
  Programs pickle, so the same program runs in a thread or in a worker
  process.
* :class:`ThreadShardExecutor`: a work-stealing
  :class:`~repro_torch.core.async_loader.ShardPool` of reader threads,
  each running the whole program per shard; it holds the cross-shard
  ``drop_duplicates`` state.
* :class:`ProcessShardExecutor`: spawned worker processes pulling shards
  from one task queue (work stealing). Raw shard bytes travel to the
  workers in shared-memory segments, and cleaned flat column buffers,
  token arrays and word counts travel back the same way.
* :class:`ShardCache`: the ``persist()`` analogue, an on-disk cache of
  cleaned column buffers, token arrays and word counts keyed by (shard
  bytes digest, column lineage fingerprint). Writes are atomic (a temp
  file, then ``os.replace``); a malformed entry is a miss, never an error.

Where the port differs. Every fingerprint and cache key carries the port's
tag (``bytesops.PORT_TAG``) and the default cache root is
``<tempdir>/repro_torch_shard_cache``: both packages read
``REPRO_CACHE_DIR``, and neither ever reads the other's entries. The
program carries the ``device`` of the ``device`` backend's scan passes,
resolved by the caller (the card unless the caller names another). Worker
processes are spawned, never forked: a forked child of a process that has
touched CUDA cannot use it. So this module imports no torch at import
time, and a child under a host backend (``loops``, ``fused``) never
imports it; under ``device`` each child makes ``program.device`` current
before the first shard whose steps it runs, and runs its scans there
itself, or raises. The remote executor's workers do the same
(:mod:`repro_torch.distributed.worker`).
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from . import bytesops as B
from . import expr as E
from . import ingest as ing
from ..data.batching import TokenSpec, VocabTable, encode_flat, encode_rows
from .engine_config import EngineConfig
from .frame import ColumnarFrame

# Vocabulary lookup tables are pure functions of the vocabulary (keyed by
# its content fingerprint); building one sorts the whole vocab, so reuse
# it across shards instead of rebuilding per shard x spec.
_VOCAB_TABLES: dict[str, VocabTable] = {}


def _vocab_table(tp: "TokenPlan") -> VocabTable:
    """Copy of ``repro/core/executor.py:78``."""
    table = _VOCAB_TABLES.get(tp.vocab_fp)
    if table is None:
        if len(_VOCAB_TABLES) > 8:  # a worker only ever sees a few vocabs
            _VOCAB_TABLES.clear()
        table = VocabTable(tp.stoi)
        _VOCAB_TABLES[tp.vocab_fp] = table
    return table

# ---------------------------------------------------------------------------
# Shard program: the picklable per-shard physical plan
# ---------------------------------------------------------------------------

# Step kinds: ("select", cols) | ("dropna", cols) | ("dedup", cols)
#           | ("project", ((out_col, compiled_expr), ...))
#           | ("filter", compiled_pred)
#           | ("dedup_emit", cols)   pass 1 of two-pass dedup: emit per-row
#                                    key digests of ``cols`` (no row change)
#           | ("dedup_take", cols)   pass 2: keep only the executor-provided
#                                    canonical-survivor rows for this shard
# Compiled expressions/predicates are the plain-tuple programs of
# :mod:`repro_torch.core.expr`, picklable as the reference's are.
Step = tuple[str, Any]

# Reserved token-space product name for two-pass dedup key digests: a
# ``(rows, 4)`` int32 view of 16-byte blake2b digests, so pass-1 keys ride
# the exact token-array transport and cache paths.
DEDUP_KEYS = "__dedup_keys__"


def _has_step(program: "ShardProgram", kind: str) -> bool:
    """Copy of ``repro/core/executor.py:109``."""
    return any(k == kind for k, _ in program.steps)


def _dedup_key_digests(cols: Sequence[Sequence], n: int) -> np.ndarray:
    """Per-row 16-byte digests of the dedup-subset values, injectively
    serialized (type tag + length prefix), viewed as ``(n, 4)`` int32.
    Digest equality stands in for the value-tuple equality whole-frame
    ``drop_duplicates`` uses (blake2b-128: collisions are negligible
    against any real corpus size). Copy of
    ``repro/core/executor.py:113``."""
    out = np.empty((n, 4), dtype=np.int32)
    for i in range(n):
        h = hashlib.blake2b(digest_size=16)
        for col in cols:
            v = col[i]
            if v is None:
                b_ = b"\x00"
            elif isinstance(v, str):
                b_ = b"\x01" + v.encode("utf-8", "surrogatepass")
            elif isinstance(v, (bool, int, float)):
                # Match the Python equality classes the whole-frame
                # tuple-key dedup uses: True == 1 == 1.0 and 0.0 == -0.0
                # must serialize identically; NaN never equals anything,
                # so each occurrence gets a unique nonce.
                if v != v:  # NaN
                    # NaN never equals anything (whole-frame keeps every
                    # NaN row), so each occurrence gets a random nonce —
                    # unique across rows, shards, and cached passes.
                    b_ = b"\x03nan" + os.urandom(8)
                else:
                    try:
                        exact = float(v) == v
                    except OverflowError:  # int beyond float range
                        exact = False
                    if exact:
                        b_ = b"\x03" + repr(float(v) + 0.0).encode()
                    else:
                        b_ = b"\x03" + repr(int(v)).encode()
            else:
                b_ = b"\x02" + repr(v).encode("utf-8")
            h.update(len(b_).to_bytes(8, "little"))
            h.update(b_)
        out[i] = np.frombuffer(h.digest(), dtype=np.int32)
    return out


@dataclass(frozen=True)
class TokenPlan:
    """Token-space tail of a shard program: encode ``specs`` against a
    fixed word-index map. Plain dict + specs, so the plan pickles like
    every other program part. Copy of
    ``repro/core/executor.py:156``."""

    specs: tuple[TokenSpec, ...]
    stoi: dict[str, int]
    vocab_fp: str


@dataclass(frozen=True)
class ShardProgram:
    """Per-shard physical program: parse ``fields``, run ``steps``, emit
    ``output_columns`` (empty tuple = every live column). ``tokens``
    appends token encoding; ``count_words`` appends per-shard word
    counting (vocabulary fitting).

    ``backend`` is the bytesops execution backend the program's op chains
    run under (resolved at compile time from the explicit option or
    ``REPRO_BYTES_BACKEND``, so it travels — pickled with the program —
    to process-pool and remote workers whose environment may differ).
    Backends are byte-identical by contract, which is why the *cache*
    lineage fingerprints deliberately exclude it. ``device`` is where the
    ``device`` backend's scan passes run (None under a host backend). Copy of
    ``repro/core/executor.py:167``."""

    fields: tuple[str, ...]
    steps: tuple[Step, ...]
    output_columns: tuple[str, ...] = ()
    tokens: TokenPlan | None = None
    count_words: tuple[str, ...] = ()
    backend: str = "device"
    device: str | None = None

    @property
    def has_dedup(self) -> bool:
        return any(kind == "dedup" for kind, _ in self.steps)


class UnsupportedPlanError(ValueError):
    """The plan cannot be compiled to a per-shard program.
    Copy of ``repro/core/executor.py:192``."""


def compile_shard_program(
    frame_nodes: Sequence[Any],
    *,
    optimize: bool = True,
    output_columns: Sequence[str] = (),
    tokens: TokenPlan | None = None,
    count_words: Sequence[str] = (),
    backend: str | None = None,
    device=None,
) -> ShardProgram:
    """Compile an (optimized) frame-level plan into a :class:`ShardProgram`.

    ``frame_nodes[0]`` must be a ``SourceJsonDirs``; ``Split`` is whole-frame
    only and rejected here. Under the ``device`` backend ``device`` is
    resolved here: the card unless the caller names another, and without
    a card this raises.
    Copy of ``repro/core/executor.py:196``.
    """
    from . import plan as P  # local import: plan.py imports this module

    src = frame_nodes[0]
    if not isinstance(src, P.SourceJsonDirs):
        raise UnsupportedPlanError("shard programs require a SourceJsonDirs source")
    steps: list[Step] = []
    for node in frame_nodes[1:]:
        if isinstance(node, P.Select):
            steps.append(("select", tuple(node.fields)))
        elif isinstance(node, P.DropNA):
            steps.append(("dropna", tuple(node.subset)))
        elif isinstance(node, P.DropDuplicates):
            steps.append(("dedup", tuple(node.subset)))
        elif isinstance(node, P.Project):
            steps.append(("project", E.compile_project(node.exprs, optimize)))
        elif isinstance(node, P.Filter):
            comp = E.compile_pred(node.pred)
            if optimize:
                comp = E.fuse_compiled(comp)
            steps.append(("filter", comp))
        else:
            raise UnsupportedPlanError(f"not shard-executable: {node.describe()}")
    backend = EngineConfig().resolve_backend(backend)
    if backend == "device":
        from ..device import resolve  # torch: a host-backend program never needs it

        device = str(resolve(device))
    return ShardProgram(
        tuple(src.fields),
        tuple(steps),
        tuple(output_columns),
        tokens=tokens,
        count_words=tuple(count_words),
        backend=backend,
        device=device if backend == "device" else None,
    )


# ---------------------------------------------------------------------------
# Column lineage fingerprints (the plan half of the cache key)
# ---------------------------------------------------------------------------


def _lineage_fingerprints(
    program: ShardProgram,
) -> tuple[dict[int, dict[str, str]], dict[str, str]] | None:
    """Per-project-step, per-output-column lineage fingerprints.

    A column's fingerprint at a project step covers, in order, every
    earlier step that can change that step's output buffer for a given
    shard: the expressions along its own lineage and every row filter
    (``dropna`` / ``filter``) — including, transitively, the lineages of
    the columns the filter reads, since *their* values decide which rows
    survive. Keys are step indices into ``program.steps``: a column
    written by two project steps gets a *different* fingerprint at each,
    so the steps never alias one cache entry. ``{}``-valued / missing
    columns are uncacheable (e.g. a predicate that cannot be
    fingerprinted, such as a lambda). Returns None when the whole program
    is uncacheable: ``dedup`` holds cross-shard state, so a shard's output
    is not a pure function of (shard bytes, program) — and neither is a
    ``dedup_take`` shard, whose surviving rows are elected from the whole
    corpus. (``dedup_emit`` stays cacheable: the key digests are a pure
    per-shard function of the prefix.)
    Copy of ``repro/core/executor.py:247``.
    """
    if program.has_dedup or _has_step(program, "dedup_take"):
        return None

    def h(sig: bytes) -> bytes:
        return hashlib.blake2b(B.PORT_TAG + sig, digest_size=16).digest()

    # None in ``lineage`` poisons a column: its value depends on something
    # we cannot fingerprint, so nothing derived from it may cache.
    lineage: dict[str, bytes | None] = {
        f: b"src:" + f.encode() for f in program.fields
    }

    def _row_filter_token(tag: bytes, cols: Sequence[str], extra: bytes) -> bytes | None:
        """Token mixed into every column's lineage by a row filter; None
        when any column the filter reads is poisoned."""
        bases = [lineage.get(c, b"src:" + c.encode()) for c in cols]
        if any(sig is None for sig in bases):
            return None
        return tag + extra + b"|" + b",".join(
            c.encode() + b"=" + sig for c, sig in zip(cols, bases)
        )

    per_step: dict[int, dict[str, str]] = {}
    for step_idx, (kind, arg) in enumerate(program.steps):
        if kind == "select":
            lineage = {c: lineage[c] for c in arg if c in lineage}
        elif kind in ("dropna", "filter"):
            if kind == "dropna":
                token = _row_filter_token(b"dropna:", arg, b"")
            else:
                try:
                    psig = E.compiled_signature(arg)
                except B.UnfingerprintableOpError:
                    token = None
                else:
                    token = _row_filter_token(
                        b"filter:", sorted(E.compiled_inputs(arg)), psig
                    )
            if token is None:
                # Unfingerprintable column/predicate decides the row set →
                # nothing downstream is a pure function of fingerprintable
                # state.
                lineage = {c: None for c in lineage}
                continue
            lineage = {
                c: h(sig + b"|" + token) if sig is not None else None
                for c, sig in lineage.items()
            }
        elif kind == "project":
            fps: dict[str, str] = {}
            for out_col, comp in arg:
                in_cols = sorted(E.compiled_inputs(comp))
                bases = [lineage.get(c, b"src:" + c.encode()) for c in in_cols]
                if any(b_ is None for b_ in bases):
                    lineage[out_col] = None
                    continue
                try:
                    esig = E.compiled_signature(comp)
                except B.UnfingerprintableOpError:
                    lineage[out_col] = None
                    continue
                sig = h(
                    b",".join(
                        c.encode() + b"=" + b_ for c, b_ in zip(in_cols, bases)
                    )
                    + b"|expr:"
                    + esig
                )
                lineage[out_col] = sig
                fps[out_col] = sig.hex()
            per_step[step_idx] = fps
    final = {c: sig.hex() for c, sig in lineage.items() if sig is not None}
    return per_step, final


def step_column_fingerprints(
    program: ShardProgram,
) -> dict[int, dict[str, str]] | None:
    """Cache-key fingerprints per clean step (see ``_lineage_fingerprints``).
    Copy of ``repro/core/executor.py:343``."""
    walked = _lineage_fingerprints(program)
    return None if walked is None else walked[0]


def column_fingerprints(program: ShardProgram) -> dict[str, str] | None:
    """End-of-program lineage fingerprint of every (fingerprintable)
    column. None when the program holds cross-shard state (dedup). Copy of
    ``repro/core/executor.py:351``."""
    walked = _lineage_fingerprints(program)
    return None if walked is None else walked[1]


def token_fingerprints(program: ShardProgram) -> dict[str, str] | None:
    """Cache-key fingerprint per token output: the source column's final
    lineage fingerprint (so any upstream op or filter change invalidates),
    the spec's own parameters (so changing one ``TokenSpec`` invalidates
    only that array), and the vocabulary fingerprint (so a refit
    invalidates token entries without touching cleaned-text entries).
    Missing entries mean that output is uncacheable; None disables token
    caching for the whole program (dedup / no token plan). Copy of
    ``repro/core/executor.py:358``."""
    if program.tokens is None:
        return None
    walked = _lineage_fingerprints(program)
    if walked is None:
        return None
    final = walked[1]
    out: dict[str, str] = {}
    for spec in program.tokens.specs:
        base = final.get(spec.column)
        if base is None:
            continue
        sig = (
            f"{base}|tok:{spec.column}->{spec.name}"
            f":{spec.max_len}:{spec.add_start_end}"
            f"|vocab:{program.tokens.vocab_fp}"
        )
        out[spec.name] = hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()
    return out


def count_fingerprint(program: ShardProgram) -> str | None:
    """Cache-key fingerprint for a shard's word counts: the final lineage
    fingerprints of every counted column (the counts are a pure function
    of those buffers). None when counting is off or any column is
    uncacheable. Copy of
    ``repro/core/executor.py:386``."""
    if not program.count_words:
        return None
    walked = _lineage_fingerprints(program)
    if walked is None:
        return None
    final = walked[1]
    parts = []
    for c in program.count_words:
        fp = final.get(c)
        if fp is None:
            return None
        parts.append(f"{c}={fp}")
    sig = "counts|" + "|".join(parts)
    return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()


def dedup_keys_fingerprint(program: ShardProgram) -> str | None:
    """Cache-key fingerprint for a shard's two-pass dedup key digests: the
    final lineage fingerprints of the subset columns (the keys are a pure
    function of those buffers and the surviving prefix rows). None when
    the program emits no keys or any subset column is uncacheable. Copy of
    ``repro/core/executor.py:407``."""
    subset = next(
        (arg for kind, arg in program.steps if kind == "dedup_emit"), None
    )
    if subset is None:
        return None
    walked = _lineage_fingerprints(program)
    if walked is None:
        return None
    final = walked[1]
    parts = []
    for c in subset:
        fp = final.get(c)
        if fp is None:
            return None
        parts.append(f"{c}={fp}")
    sig = "dedupkeys|" + "|".join(parts)
    return hashlib.blake2b(sig.encode(), digest_size=16).hexdigest()


def split_dedup_programs(
    frame_nodes: Sequence[Any],
    *,
    optimize: bool = True,
    count_columns: Sequence[str] = (),
    output_columns: Sequence[str] | None = None,
    tokens: TokenPlan | None = None,
    backend: str | None = None,
    device=None,
) -> tuple[ShardProgram, ShardProgram]:
    """Compile the two programs of two-pass canonical-survivor dedup.

    The plan must hold exactly one ``DropDuplicates`` node. Pass 1 runs
    the plan prefix up to it — re-planned against the dedup subset, so
    transforms that only feed the counted columns are pruned away — and
    emits per-row key digests (``dedup_emit``). The caller merges the
    digests, electing the first occurrence in deterministic
    ``(shard index, row index)`` order — exactly the row whole-frame
    keep-first dedup retains. Pass 2 re-runs the full plan with the dedup
    step replaced by ``dedup_take`` of the elected survivor rows, so the
    stream stays a pure per-shard program (process-executor capable, no
    cross-shard mutable state) yet byte-identical to whole-frame.

    Pass 2's tail is configurable so both streaming terminals share the
    protocol: ``count_columns`` appends word counting (``fit_vocab``),
    ``tokens`` appends token encoding (``iter_batches``). By default the
    emitted columns are ``count_columns``; pass ``output_columns`` to
    override (e.g. the tokenize spec columns).
    Copy of ``repro/core/executor.py:431``.
    """
    from . import plan as P

    idxs = [
        i for i, n in enumerate(frame_nodes) if isinstance(n, P.DropDuplicates)
    ]
    if len(idxs) != 1:
        # Build-time diagnostic (program compilation — nothing has spawned
        # yet), naming each offending Dedup node. The plan analyzer
        # (P005, repro_torch.analysis) rejects this shape at validate time; this
        # is the compile-time backstop for direct callers.
        from ..analysis.diagnostics import (
            Diagnostic,
            PlanValidationError,
            node_ref,
        )

        provenance = tuple(node_ref(i, frame_nodes[i]) for i in idxs)
        raise PlanValidationError(
            [
                Diagnostic(
                    "P005",
                    f"two-pass dedup requires exactly one DropDuplicates "
                    f"node, found {len(idxs)}: a partial-subset "
                    "drop_duplicates cannot stack with another "
                    "drop_duplicates in a per-shard program",
                    provenance=provenance,
                )
            ]
        )
    j = idxs[0]
    subset = tuple(frame_nodes[j].subset)
    prefix = list(frame_nodes[:j])
    if optimize:
        prefix = P.optimize_plan(prefix, subset)
    pass1 = compile_shard_program(prefix, optimize=optimize, backend=backend,
                                  device=device)
    pass1 = dataclasses.replace(
        pass1, steps=pass1.steps + (("dedup_emit", subset),)
    )
    full = compile_shard_program(
        frame_nodes,
        optimize=optimize,
        output_columns=(
            count_columns if output_columns is None else output_columns
        ),
        tokens=tokens,
        count_words=count_columns,
        backend=backend,
        device=device,
    )
    steps2 = list(full.steps)
    if steps2[j - 1] != ("dedup", subset):  # nodes[1:] map 1:1 to steps
        raise UnsupportedPlanError(
            f"plan-to-step mapping drift: expected dedup at step {j - 1}, "
            f"found {steps2[j - 1]!r}"
        )
    steps2[j - 1] = ("dedup_take", subset)
    pass2 = dataclasses.replace(full, steps=tuple(steps2))
    return pass1, pass2


def elect_survivors(
    shards: Sequence[str | Path],
    pass1: ShardProgram,
    exec_kw: dict,
    stats: dict | None = None,
) -> dict[int, np.ndarray]:
    """Run pass 1 of two-pass dedup (see :func:`split_dedup_programs`)
    over every shard and keep, per key digest, the minimal ``(shard
    index, row index)`` occurrence — the row whole-frame keep-first dedup
    retains. Returns per-shard sorted survivor row indices (an entry for
    every shard, possibly empty), the ``row_filters`` input of
    :func:`make_executor`. Copy of
    ``repro/core/executor.py:518``."""
    survivors: dict[bytes, tuple[int, int]] = {}
    exec1 = make_executor(shards, pass1, **exec_kw)
    try:
        for res in exec1:
            keys = res.tokens.get(DEDUP_KEYS)
            if keys is None or not len(keys):
                continue
            si = res.shard_index
            # Within-shard first occurrence per key is vectorized
            # (np.unique on the 16-byte digests); only the per-shard
            # uniques cross into the Python merge loop.
            voids = np.ascontiguousarray(keys).view(
                np.dtype((np.void, 16))
            ).reshape(-1)
            uniq, first = np.unique(voids, return_index=True)
            for k_void, ri in zip(uniq, first):
                k = k_void.tobytes()
                best = survivors.get(k)
                if best is None or (si, int(ri)) < best:
                    survivors[k] = (si, int(ri))
    finally:
        exec1.stop()
        if stats is not None:
            stats["token_cache_hits"] = (
                stats.get("token_cache_hits", 0) + exec1.token_cache_hits
            )
            stats["token_cache_misses"] = (
                stats.get("token_cache_misses", 0) + exec1.token_cache_misses
            )
    per_shard: dict[int, list[int]] = {i: [] for i in range(len(shards))}
    for si, ri in survivors.values():
        per_shard[si].append(ri)
    return {
        i: np.sort(np.asarray(rows, dtype=np.int64))
        for i, rows in per_shard.items()
    }


# ---------------------------------------------------------------------------
# On-disk shard cache (the Spark persist() analogue)
# ---------------------------------------------------------------------------


def default_cache_dir() -> Path:
    """``REPRO_CACHE_DIR``, else ``<tempdir>/repro_torch_shard_cache``.
    Copy of ``repro/core/executor.py:573``."""
    env = os.environ.get("REPRO_CACHE_DIR")
    if env:
        return Path(env)
    return Path(tempfile.gettempdir()) / "repro_torch_shard_cache"


class ShardCache:
    """Content-addressed store of cleaned column buffers, token arrays,
    and per-shard word counts.

    One ``.npy`` file per (shard digest, column, lineage fingerprint).
    Writes are atomic (tmp + rename); reads treat any malformed entry as a
    miss and delete it, so a corrupted cache degrades to recompute. Entry
    kinds never alias: text entries are 1-D uint8 flat buffers, token
    entries are 2-D int32 arrays, counts are JSON-encoded uint8 — and the
    loaders validate shape/dtype, so a key collision across kinds reads as
    a miss rather than garbage.
    Copy of ``repro/core/executor.py:580``.
    """

    def __init__(self, root: str | Path | None = None):
        self.root = Path(root) if root is not None else default_cache_dir()
        self.root.mkdir(parents=True, exist_ok=True)

    def key(self, shard_digest: str, column: str, column_fp: str) -> str:
        return hashlib.blake2b(
            B.PORT_TAG + f"{shard_digest}:{column}:{column_fp}".encode(), digest_size=16
        ).hexdigest()

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.npy"

    def load(self, key: str) -> np.ndarray | None:
        path = self._path(key)
        try:
            buf = np.load(path, allow_pickle=False)
            if buf.dtype != np.uint8 or buf.ndim != 1:
                raise ValueError("wrong cache payload shape")
            return buf
        except FileNotFoundError:
            return None
        except Exception:
            # Corrupted entry (truncated write, garbage, wrong format):
            # recompute instead of crashing, and drop the bad file.
            try:
                path.unlink()
            except OSError:
                pass
            return None

    def contains(self, key: str) -> bool:
        """Existence probe (no validation) — used for cheap caller-side
        fast-path checks; loaders still validate on read."""
        return self._path(key).exists()

    def load_tokens(self, key: str, max_len: int) -> np.ndarray | None:
        """Load a token-array entry ((rows, max_len) int32); corrupt or
        wrong-shape entries degrade to a miss."""
        path = self._path(key)
        try:
            arr = np.load(path, allow_pickle=False)
            if arr.dtype != np.int32 or arr.ndim != 2 or arr.shape[1] != max_len:
                raise ValueError("wrong token cache payload shape")
            return arr
        except FileNotFoundError:
            return None
        except Exception:
            try:
                path.unlink()
            except OSError:
                pass
            return None

    def load_counts(self, key: str) -> Counter | None:
        buf = self.load(key)
        if buf is None:
            return None
        try:
            return Counter(json.loads(buf.tobytes().decode("utf-8")))
        except Exception:
            try:
                self._path(key).unlink()
            except OSError:
                pass
            return None

    def store_counts(self, key: str, counts: Counter) -> None:
        try:
            data = json.dumps(dict(counts), ensure_ascii=False).encode("utf-8")
        except (TypeError, ValueError, UnicodeEncodeError):
            return  # unserializable corner (lone surrogates): skip caching
        self.store(key, np.frombuffer(data, dtype=np.uint8))

    def store(self, key: str, buf: np.ndarray) -> None:
        path = self._path(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    np.save(fh, buf, allow_pickle=False)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            pass  # cache is best-effort; never fail the pipeline


# ---------------------------------------------------------------------------
# Program execution (shared by thread and process workers)
# ---------------------------------------------------------------------------


@dataclass
class ShardResult:
    """One processed shard: the cleaned frame plus execution accounting.

    For token-space programs ``tokens`` holds the int32 arrays (one per
    ``TokenSpec``) and ``word_counts`` the shard's word ``Counter`` — the
    frame may then be empty (the process executor ships only token
    buffers, and a fully token-cached shard skips parsing entirely). Copy of
    ``repro/core/executor.py:687``."""

    frame: ColumnarFrame
    parse_s: float = 0.0
    pre_clean_s: float = 0.0
    clean_s: float = 0.0
    post_clean_s: float = 0.0
    tokenize_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    token_cache_hits: int = 0
    token_cache_misses: int = 0
    tokens: dict = dataclasses.field(default_factory=dict)
    word_counts: Counter | None = None
    # Flat buffers not yet folded into ``frame`` (materialize=False only).
    flat: dict = dataclasses.field(default_factory=dict)
    # Which shard (position in the executor's shard list) produced this
    # result — arrival order is nondeterministic under work stealing, so
    # consumers that need a deterministic ordering (two-pass dedup
    # election) key on this instead.
    shard_index: int = -1


class GlobalDedup:
    """Thread-safe keep-first dedup across shards, taken in shard order.

    Copy of ``repro/core/executor.py:716``, which keeps the first copy to
    reach it in arrival order: with more than one reader thread a
    duplicate that spans two shards then survives in whichever shard's
    thread gets there first, and the batch stream differs from run to run.
    Here each shard's dedup step waits for its turn (shard ``k`` after
    shards ``0..k-1`` have passed theirs or ended), so every run keeps the
    copy whole-frame ``drop_duplicates`` keeps and streams the same
    batches. Parsing and every other step still overlap across threads.
    A call without ``shard_index`` takes no turn (arrival order)."""

    def __init__(self, subset: tuple[str, ...]):
        self.subset = subset
        self._seen: set = set()
        self._cond = threading.Condition()
        self._turn = 0  # the shard whose dedup step goes next
        self._passed: set[int] = set()
        self._abandoned = False

    def _advance(self) -> None:
        while self._turn in self._passed:
            self._turn += 1
        self._cond.notify_all()

    def keep_mask(self, frame: ColumnarFrame, shard_index: int | None = None) -> np.ndarray:
        cols = [frame[f] for f in self.subset]
        n = len(frame)
        # Build keys outside the lock so reader threads only serialize on
        # the set membership check, not the per-row tuple construction.
        keys = [tuple(c[i] for c in cols) for i in range(n)]
        keep = np.ones(n, dtype=bool)
        with self._cond:
            if shard_index is not None:
                self._cond.wait_for(lambda: self._turn == shard_index or self._abandoned)
            for i, key in enumerate(keys):
                if key in self._seen:
                    keep[i] = False
                else:
                    self._seen.add(key)
            if shard_index is not None:
                self._passed.add(shard_index)
                self._advance()
        return keep

    def done(self, shard_index: int) -> None:
        """Shard ``shard_index`` will take no (further) turn: it passed its
        dedup step or ended before it. Idempotent."""
        with self._cond:
            self._passed.add(shard_index)
            self._advance()

    def abandon(self) -> None:
        """Release every waiting shard: the epoch was abandoned."""
        with self._cond:
            self._abandoned = True
            self._cond.notify_all()

    def filter(self, frame: ColumnarFrame) -> ColumnarFrame:
        return frame.take(self.keep_mask(frame))


# -- flat-buffer row ops (cleaned columns stay flat through the program) ----


def _flat_take(buf: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Row-filter a flat buffer without decoding it. Copy of ``repro/core/executor.py:746``."""
    if buf.size == 0 or keep.all():
        return buf
    return buf[np.repeat(keep, B.row_lengths(buf))]


def _run_project_step(
    n: int,
    flat: dict[str, np.ndarray],
    lookup,
    entries: Sequence[tuple[str, tuple]],
    cache: ShardCache | None,
    step_fps: dict[str, str] | None,
    digest: str | None,
    result: ShardResult,
    backend: str = "device",
    device=None,
) -> None:
    """Run one Project step's compiled expressions over flat buffers, one
    cache lookup per output column. A hit replaces the expression with a
    disk read; a miss (including a corrupt or row-count-stale entry)
    recomputes just that column and rewrites the entry, so
    partially-changed plans only pay for the columns whose lineage
    actually changed. Copy of
    ``repro/core/executor.py:753``."""
    cacheable = cache is not None and step_fps is not None and digest is not None

    for out_col, comp in entries:
        if comp[0] == "chain" and not comp[2]:
            # Pure alias (a CSE consumer whose whole chain was hoisted):
            # share the memoized buffer; no lookup, no hit/miss counted.
            flat[out_col] = lookup(comp[1])
            continue
        key = None
        if cacheable:
            fp = step_fps.get(out_col)
            key = cache.key(digest, out_col, fp) if fp else None
            hit = cache.load(key) if key else None
            if hit is not None and B.n_rows(hit) == n:
                flat[out_col] = hit
                result.cache_hits += 1
                continue
        out = E.eval_str(comp, lookup, n, backend, device)
        flat[out_col] = out
        if key:
            # Uncacheable columns (key None) count neither hit nor miss:
            # no lookup happened, and a warm run should still report 100%.
            result.cache_misses += 1
            cache.store(key, out)


def _cached_product_keys(
    program: ShardProgram,
    cache: ShardCache | None,
    token_fps: dict[str, str] | None,
    count_fp: str | None,
    digest: str | None,
    dedup_fp: str | None = None,
) -> list[str] | None:
    """Cache keys of every token-space product the program emits, or None
    when the program/cache cannot serve a shard from cache at all. Copy of
    ``repro/core/executor.py:796``."""
    if cache is None or digest is None:
        return None
    emits_keys = _has_step(program, "dedup_emit")
    if program.tokens is None and not program.count_words and not emits_keys:
        return None
    keys: list[str] = []
    if program.tokens is not None:
        if not token_fps or set(token_fps) != {s.name for s in program.tokens.specs}:
            return None
        keys += [
            cache.key(digest, spec.name, token_fps[spec.name])
            for spec in program.tokens.specs
        ]
    if program.count_words:
        if count_fp is None:
            return None
        keys.append(cache.key(digest, "__word_counts__", count_fp))
    if emits_keys:
        if dedup_fp is None:
            return None
        keys.append(cache.key(digest, DEDUP_KEYS, dedup_fp))
    return keys


def products_fully_cached(
    program: ShardProgram,
    cache: ShardCache | None,
    token_fps: dict[str, str] | None,
    count_fp: str | None,
    digest: str,
    dedup_fp: str | None = None,
) -> bool:
    """Cheap existence probe for the full-shard fast path (the reference's
    process executor skips a shard's copy on it). Copy of
    ``repro/core/executor.py:830``."""
    keys = _cached_product_keys(
        program, cache, token_fps, count_fp, digest, dedup_fp
    )
    return keys is not None and all(cache.contains(k) for k in keys)


def _load_cached_products(
    program: ShardProgram,
    cache: ShardCache | None,
    token_fps: dict[str, str] | None,
    count_fp: str | None,
    digest: str | None,
    dedup_fp: str | None = None,
) -> ShardResult | None:
    """Serve a shard entirely from the token-space cache: when every
    product the program emits (all token arrays, the word counts, the
    two-pass dedup key digests) is cached under the current fingerprints,
    the shard needs no parse, no cleaning, and no encode. None → run the
    program normally. Copy of
    ``repro/core/executor.py:846``."""
    if cache is None or digest is None:
        return None
    emits_keys = _has_step(program, "dedup_emit")
    if program.tokens is None and not program.count_words and not emits_keys:
        return None
    tokens: dict[str, np.ndarray] = {}
    hits = 0
    n: int | None = None
    if program.tokens is not None:
        if not token_fps or set(token_fps) != {s.name for s in program.tokens.specs}:
            return None
        for spec in program.tokens.specs:
            key = cache.key(digest, spec.name, token_fps[spec.name])
            arr = cache.load_tokens(key, spec.max_len)
            if arr is None or (n is not None and len(arr) != n):
                return None  # partial/inconsistent: recompute the shard
            n = len(arr)
            tokens[spec.name] = arr
        hits += len(tokens)
    counts: Counter | None = None
    if program.count_words:
        if count_fp is None:
            return None
        counts = cache.load_counts(cache.key(digest, "__word_counts__", count_fp))
        if counts is None:
            return None
        hits += 1
    if emits_keys:
        if dedup_fp is None:
            return None
        arr = cache.load_tokens(cache.key(digest, DEDUP_KEYS, dedup_fp), 4)
        if arr is None:
            return None
        tokens[DEDUP_KEYS] = arr
        hits += 1
    result = ShardResult(ColumnarFrame({}))
    result.tokens = tokens
    result.word_counts = counts
    result.token_cache_hits = hits
    return result


def execute_program(
    frame: ColumnarFrame,
    program: ShardProgram,
    *,
    dedups: dict[int, GlobalDedup] | None = None,
    cache: ShardCache | None = None,
    col_fps: dict[int, dict[str, str]] | None = None,
    token_fps: dict[str, str] | None = None,
    count_fp: str | None = None,
    dedup_fp: str | None = None,
    digest: str | None = None,
    row_take: np.ndarray | None = None,
    materialize: bool = True,
    shard_index: int | None = None,
) -> ShardResult:
    """Run every step of ``program`` on one parsed shard frame.

    Cleaned columns live as *flat* byte buffers from their op chain until
    the very end — row filters apply straight to the buffers — so no
    decode/re-encode round trip happens inside the program; token encoding
    and word counting read the surviving rows straight off those buffers.
    With ``materialize=False`` the buffers are left in ``result.flat`` (the
    token products are the output); ``materialize=True`` folds them back
    into the frame. ``shard_index`` is the shard's turn at a cross-shard
    dedup step (:class:`GlobalDedup`).
    Copy of ``repro/core/executor.py:901``.
    """
    result = ShardResult(frame)
    flat: dict[str, np.ndarray] = {}
    # Raw source columns flatten at most once; the memo is row-filtered in
    # lockstep with ``flat`` so filters never force a re-flatten either.
    src_flat: dict[str, np.ndarray] = {}

    def lookup(c: str) -> np.ndarray:
        if c in flat:
            return flat[c]
        if c not in src_flat:
            src_flat[c] = frame.flat(c)
        return src_flat[c]

    def take_rows(keep: np.ndarray) -> None:
        nonlocal frame, flat, src_flat
        if keep.all():
            return
        frame = frame.take(keep)
        flat = {c: _flat_take(b, keep) for c, b in flat.items()}
        src_flat = {c: _flat_take(b, keep) for c, b in src_flat.items()}

    seen_clean = False
    for step_idx, (kind, arg) in enumerate(program.steps):
        t0 = time.perf_counter()
        if kind == "select":
            for c in arg:  # flat-only columns need a frame slot to survive
                if c in flat and c not in frame.columns:
                    frame = frame.ensure_column(c)
            frame = frame.select([c for c in arg if c in frame.columns])
            flat = {c: b for c, b in flat.items() if c in arg}
            src_flat = {c: b for c, b in src_flat.items() if c in arg}
        elif kind == "dropna":
            keep = np.ones(len(frame), dtype=bool)
            for c in arg:
                if c in flat:
                    keep &= B.row_nonempty(flat[c])
                else:
                    col = frame[c]
                    keep &= np.array(
                        [v is not None and v != "" for v in col], dtype=bool
                    )
            take_rows(keep)
        elif kind == "filter":
            take_rows(E.eval_mask(arg, lookup, len(frame), program.backend,
                                  program.device))
        elif kind == "dedup":
            if dedups is None:
                raise UnsupportedPlanError(
                    "dedup step requires executor-provided cross-shard state"
                )
            # Dedup compares real values: decode any flat subset column
            # back into the frame first (dedup plans are thread-only and
            # uncacheable, so this is the status-quo cost).
            for c in dedups[step_idx].subset:
                if c in flat:
                    frame = frame.ensure_column(c).with_flat(c, flat.pop(c))
                    src_flat.pop(c, None)
            keep = dedups[step_idx].keep_mask(frame, shard_index)
            take_rows(keep)
        elif kind == "dedup_emit":
            # Pass 1 of two-pass dedup: per-row key digests of the subset
            # columns at this point (rows unchanged). Cacheable — the
            # digests are a pure per-shard function of the prefix.
            keys_arr = None
            key = None
            if cache is not None and dedup_fp is not None and digest is not None:
                key = cache.key(digest, DEDUP_KEYS, dedup_fp)
                keys_arr = cache.load_tokens(key, 4)
                if keys_arr is not None and len(keys_arr) == len(frame):
                    result.token_cache_hits += 1
                else:
                    keys_arr = None
            if keys_arr is None:
                vals = [
                    B.unflatten(flat[c]) if c in flat else list(frame[c])
                    for c in arg
                ]
                keys_arr = _dedup_key_digests(vals, len(frame))
                if key:
                    result.token_cache_misses += 1
                    cache.store(key, keys_arr)
            result.tokens[DEDUP_KEYS] = keys_arr
        elif kind == "dedup_take":
            # Pass 2: keep exactly the canonical-survivor rows the caller
            # elected for this shard (row indices at this plan point).
            if row_take is None:
                raise UnsupportedPlanError(
                    "dedup_take step requires executor-provided survivor rows"
                )
            keep = np.zeros(len(frame), dtype=bool)
            keep[np.asarray(row_take, dtype=np.int64)] = True
            take_rows(keep)
        elif kind == "project":
            step_fps = col_fps.get(step_idx) if col_fps is not None else None
            _run_project_step(
                len(frame), flat, lookup, arg, cache, step_fps, digest, result,
                program.backend, program.device,
            )
        dt = time.perf_counter() - t0
        if kind == "project":
            seen_clean = True
            result.clean_s += dt
        elif seen_clean:
            result.post_clean_s += dt
        else:
            result.pre_clean_s += dt
    if program.output_columns:
        live = set(program.output_columns)
        for c in live:
            if c in flat and c not in frame.columns:
                frame = frame.ensure_column(c)
        frame = frame.select([c for c in frame.columns if c in live])
        flat = {c: b for c, b in flat.items() if c in live}

    # -- token space: encode + count on the surviving rows ------------------
    if program.tokens is not None or program.count_words:
        rows_memo: dict[str, list] = {}

        def rows_of(col: str) -> list:
            if col not in rows_memo:
                if col in flat:
                    rows_memo[col] = B.unflatten(flat[col])
                else:
                    rows_memo[col] = list(frame[col])
            return rows_memo[col]

        t0 = time.perf_counter()
        n = len(frame)
        if program.tokens is not None:
            tp = program.tokens
            table = _vocab_table(tp)
            for spec in tp.specs:
                key = None
                if cache is not None and token_fps is not None and digest is not None:
                    fp = token_fps.get(spec.name)
                    key = cache.key(digest, spec.name, fp) if fp else None
                    if key:
                        hit = cache.load_tokens(key, spec.max_len)
                        if hit is not None and len(hit) == n:
                            result.tokens[spec.name] = hit
                            result.token_cache_hits += 1
                            continue
                if spec.column in flat:
                    # Cleaned columns encode straight off their flat byte
                    # buffer — no unflatten, no per-row Python.
                    arr = encode_flat(
                        flat[spec.column], table, spec.max_len, spec.add_start_end
                    )
                else:
                    arr = encode_rows(
                        rows_of(spec.column), tp.stoi, spec.max_len,
                        spec.add_start_end, table=table,
                    )
                result.tokens[spec.name] = arr
                if key:
                    result.token_cache_misses += 1
                    cache.store(key, arr)
        if program.count_words:
            counts = None
            key = None
            if cache is not None and count_fp is not None and digest is not None:
                key = cache.key(digest, "__word_counts__", count_fp)
                counts = cache.load_counts(key)
                if counts is not None:
                    result.token_cache_hits += 1
            if counts is None:
                counts = Counter()
                for col in program.count_words:
                    for t in rows_of(col):
                        counts.update((t or "").split())
                if key:
                    result.token_cache_misses += 1
                    cache.store_counts(key, counts)
            result.word_counts = counts
        result.tokenize_s += time.perf_counter() - t0

    if materialize:
        for c, b in flat.items():
            frame = frame.ensure_column(c).with_flat(c, b)
        flat = {}
    result.frame = frame
    result.flat = flat
    return result


# ---------------------------------------------------------------------------
# Thread executor (the ShardPool path, now program-driven)
# ---------------------------------------------------------------------------


class ThreadShardExecutor:
    """Work-stealing reader threads, one full program run per shard; the
    keep-first set of a cross-shard ``drop_duplicates`` lives in this
    process. Copy of
    ``repro/core/executor.py:1114``."""

    name = "thread"

    def __init__(
        self,
        shards: Sequence[str | Path],
        program: ShardProgram,
        *,
        workers: int = 2,
        cache_dir: str | Path | None = None,
        row_filters: dict[int, np.ndarray] | None = None,
    ):
        self.program = program
        self.cache_hits = 0
        self.cache_misses = 0
        self.token_cache_hits = 0
        self.token_cache_misses = 0
        self._cache = ShardCache(cache_dir) if cache_dir is not None else None
        self._col_fps = step_column_fingerprints(program) if self._cache else None
        self._token_fps = token_fingerprints(program) if self._cache else None
        self._count_fp = count_fingerprint(program) if self._cache else None
        self._dedup_fp = dedup_keys_fingerprint(program) if self._cache else None
        self._row_filters = row_filters
        self._shard_idx = {Path(s): i for i, s in enumerate(shards)}
        self._dedups = {
            i: GlobalDedup(arg)
            for i, (kind, arg) in enumerate(program.steps)
            if kind == "dedup"
        }
        self._agg_lock = threading.Lock()
        self._parse_s = self._pre_s = self._clean_s = self._post_s = 0.0
        self._tokenize_s = 0.0
        from .async_loader import ShardPool  # torch: a process child never needs it

        self._pool = ShardPool(
            shards, self._process, n_readers=max(int(workers), 1)
        )

    def _process(self, path: Path) -> ShardResult:
        idx = self._shard_idx[path]
        try:
            return self._run(path, idx)
        finally:
            for dedup in self._dedups.values():  # later shards' turns never wait on this one
                dedup.done(idx)

    def _run(self, path: Path, idx: int) -> ShardResult:
        t0 = time.perf_counter()
        if self._cache is not None:
            data, digest = ing.read_shard_bytes(path)
            fast = _load_cached_products(
                self.program, self._cache, self._token_fps, self._count_fp,
                digest, self._dedup_fp,
            )
            if fast is not None:
                fast.parse_s = time.perf_counter() - t0
                fast.shard_index = idx
                return fast
            frame = ing.parse_shard_bytes(data, self.program.fields)
        else:
            digest = None
            frame = ing.parse_shard(path, self.program.fields)
        parse_s = time.perf_counter() - t0
        res = execute_program(
            frame,
            self.program,
            dedups=self._dedups,
            cache=self._cache,
            col_fps=self._col_fps,
            token_fps=self._token_fps,
            count_fp=self._count_fp,
            dedup_fp=self._dedup_fp,
            digest=digest,
            row_take=(
                self._row_filters.get(idx)
                if self._row_filters is not None
                else None
            ),
            # Token/count/key products are the output; folding flat buffers
            # back into the frame would be wasted decode work.
            materialize=(
                self.program.tokens is None
                and not self.program.count_words
                and not _has_step(self.program, "dedup_emit")
            ),
            shard_index=idx,
        )
        res.parse_s = parse_s
        res.shard_index = idx
        return res

    def _account(self, res: ShardResult) -> None:
        with self._agg_lock:
            self._parse_s += res.parse_s
            self._pre_s += res.pre_clean_s
            self._clean_s += res.clean_s
            self._post_s += res.post_clean_s
            self._tokenize_s += res.tokenize_s
            self.cache_hits += res.cache_hits
            self.cache_misses += res.cache_misses
            self.token_cache_hits += res.token_cache_hits
            self.token_cache_misses += res.token_cache_misses

    @property
    def timings(self):
        from .plan import StageTimings

        return StageTimings(
            self._parse_s, self._pre_s, self._clean_s, self._post_s, self._tokenize_s
        )

    def __iter__(self) -> Iterator[ShardResult]:
        for res in self._pool:
            self._account(res)
            yield res

    def stop(self) -> None:
        for dedup in self._dedups.values():
            dedup.abandon()
        self._pool.stop()


# ---------------------------------------------------------------------------
# Process executor: the shared-memory wire format
# ---------------------------------------------------------------------------


def shared_memory_available() -> bool:
    """Whether POSIX shared memory works here (creating a segment also
    starts this process's resource tracker). Copy of
    ``repro/core/executor.py:1235``."""
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True, size=16)
    except (ImportError, OSError):  # a platform without /dev/shm
        return False
    seg.close()
    seg.unlink()
    return True


def _utf8_roundtrips(v: str) -> bool:
    """False for strings flatten() would mangle (lone surrogates from the
    stdlib-json fallback): those must ride the obj_rows side channel so
    the process executor stays value-identical with the thread path. Copy
    of ``repro/core/executor.py:1247``."""
    try:
        v.encode("utf-8")
        return "\x00" not in v
    except UnicodeEncodeError:
        return False


def _pack_columns(
    frame: ColumnarFrame, flat: dict[str, np.ndarray], columns: Sequence[str]
) -> tuple[bytes, list[dict]]:
    """Pack columns as (flat uint8 bytes + int64 row-end offsets) sections.

    Cleaned columns ship their program-output buffer as-is (no re-encode);
    untouched columns flatten here and carry their non-string originals
    (None, numbers, …) in the metadata so the round trip is value-exact —
    the thread and whole-frame executors never coerce those. Copy of
    ``repro/core/executor.py:1258``."""
    parts: list[bytes] = []
    metas: list[dict] = []
    pos = 0
    for col in columns:
        if col in flat:
            buf = flat[col]
            obj_rows: list[tuple[int, Any]] = []  # op output is always a string
        else:
            buf = frame.flat(col)
            obj_rows = [
                (i, v)
                for i, v in enumerate(frame[col])
                if not isinstance(v, str) or not _utf8_roundtrips(v)
            ]
        offsets = np.flatnonzero(buf == B.ROW_SEP).astype(np.int64)
        raw = buf.tobytes()
        offs = offsets.tobytes()
        metas.append(
            {
                "name": col,
                "buf_off": pos,
                "buf_len": len(raw),
                "offs_off": pos + len(raw),
                "n_rows": int(offsets.size),
                "obj_rows": obj_rows,
            }
        )
        parts.append(raw)
        parts.append(offs)
        pos += len(raw) + len(offs)
    return b"".join(parts), metas


def _unpack_columns(payload: memoryview, metas: list[dict]) -> ColumnarFrame:
    """Inverse of :func:`_pack_columns`. Copy of
    ``repro/core/executor.py:1300``."""
    cols: dict[str, np.ndarray] = {}
    for m in metas:
        raw = bytes(payload[m["buf_off"] : m["buf_off"] + m["buf_len"]])
        offsets = np.frombuffer(
            payload, dtype=np.int64, count=m["n_rows"], offset=m["offs_off"]
        )
        starts = np.concatenate(([0], offsets[:-1] + 1)) if m["n_rows"] else []
        rows: list = [
            raw[s:e].decode("utf-8", errors="ignore")
            for s, e in zip(starts, offsets)
        ]
        for i, v in m["obj_rows"]:
            rows[i] = v
        cols[m["name"]] = np.array(rows, dtype=object)
    return ColumnarFrame(cols)


def _pack_tokens(
    payload: bytes, tokens: dict[str, np.ndarray]
) -> tuple[bytes, list[dict]]:
    """Append int32 token arrays to a payload as 8-byte-aligned raw
    sections (metadata records name/offset/shape). Copy of
    ``repro/core/executor.py:1318``."""
    buf = bytearray(payload)
    metas: list[dict] = []
    for name, arr in tokens.items():
        buf += b"\x00" * ((-len(buf)) % 8)
        metas.append(
            {
                "name": name,
                "off": len(buf),
                "rows": int(arr.shape[0]),
                "width": int(arr.shape[1]),
            }
        )
        buf += np.ascontiguousarray(arr, dtype=np.int32).tobytes()
    return bytes(buf), metas


def _unpack_tokens(payload: memoryview, metas: list[dict]) -> dict[str, np.ndarray]:
    """Inverse of :func:`_pack_tokens`, copying out of the segment. Copy of
    ``repro/core/executor.py:1339``."""
    out: dict[str, np.ndarray] = {}
    for m in metas:
        arr = np.frombuffer(
            payload, dtype=np.int32, count=m["rows"] * m["width"], offset=m["off"]
        ).reshape(m["rows"], m["width"])
        out[m["name"]] = arr.copy()  # the shm segment is unlinked after
    return out


def program_fingerprint(program: ShardProgram) -> str:
    """Content fingerprint of a compiled shard program, port-tagged
    (``Dataset.row_program`` keys the serving cache on it; the reference's
    remote data plane keys result dedup on it). Copy of
    ``repro/core/executor.py:1349``."""
    return hashlib.blake2b(
        B.PORT_TAG + pickle.dumps(program, protocol=4), digest_size=16
    ).hexdigest()


class ProgramContext:
    """Per-process execution state for one compiled program: the shard
    cache handle plus every derived fingerprint, computed once per worker
    instead of once per shard. The process executor's workers drive shards
    through :meth:`run`. Copy of
    ``repro/core/executor.py:1361``."""

    def __init__(self, program: ShardProgram, cache_dir: str | Path | None):
        self.program = program
        self.cache = ShardCache(cache_dir) if cache_dir is not None else None
        has_cache = self.cache is not None
        self.col_fps = step_column_fingerprints(program) if has_cache else None
        self.token_fps = token_fingerprints(program) if has_cache else None
        self.count_fp = count_fingerprint(program) if has_cache else None
        self.dedup_fp = dedup_keys_fingerprint(program) if has_cache else None
        self.token_space = (
            program.tokens is not None
            or bool(program.count_words)
            or _has_step(program, "dedup_emit")
        )

    def run(
        self,
        data: bytes | None,
        path: str | Path | None,
        digest: str | None,
        row_take: np.ndarray | None,
        before_steps: Callable[[], None] | None = None,
    ) -> ShardResult:
        """Execute the program on one shard: serve fully-cached products
        without parsing when possible, else parse ``data`` (read from
        ``path`` when ``data`` is None — the fully-cached fast path's rare
        fallback) and run every step, calling ``before_steps`` first (its
        time counts in no stage). Wall time not attributed to a specific
        stage lands in ``parse_s``."""
        t0 = time.perf_counter()
        res = _load_cached_products(
            self.program, self.cache, self.token_fps, self.count_fp, digest,
            self.dedup_fp,
        )
        if res is None:
            if before_steps is not None:
                t_before = time.perf_counter()
                before_steps()
                t0 += time.perf_counter() - t_before  # no stage's time
            if data is None:
                with open(path, "rb") as fh:
                    data = fh.read()
            frame = ing.parse_shard_bytes(data, self.program.fields)
            res = execute_program(
                frame,
                self.program,
                cache=self.cache,
                col_fps=self.col_fps,
                token_fps=self.token_fps,
                count_fp=self.count_fp,
                dedup_fp=self.dedup_fp,
                digest=digest,
                row_take=row_take,
                materialize=False,
            )
        res.parse_s = time.perf_counter() - t0 - res.tokenize_s - (
            res.pre_clean_s + res.clean_s + res.post_clean_s
        )
        return res


def pack_shard_result(res: ShardResult, *, token_space: bool) -> tuple[dict, bytes]:
    """Serialize one :class:`ShardResult` into the executor wire format:
    flat column sections (:func:`_pack_columns`) followed by 8-byte-aligned
    int32 token sections (:func:`_pack_tokens`), with a metadata dict
    carrying section offsets, counters, and timings. Copy of
    ``repro/core/executor.py:1422``."""
    if token_space:
        # Token arrays / counts are the product; text columns stay in the
        # worker instead of riding the transport for nothing.
        payload, metas = b"", []
    else:
        out_cols = list(dict.fromkeys(list(res.frame.columns) + list(res.flat)))
        payload, metas = _pack_columns(res.frame, res.flat, out_cols)
    payload, tok_metas = _pack_tokens(payload, res.tokens)
    meta = {
        "size": len(payload),
        "columns": metas,
        "tokens": tok_metas,
        "word_counts": (
            dict(res.word_counts) if res.word_counts is not None else None
        ),
        "parse_s": res.parse_s,
        "pre_clean_s": res.pre_clean_s,
        "clean_s": res.clean_s,
        "post_clean_s": res.post_clean_s,
        "tokenize_s": res.tokenize_s,
        "cache_hits": res.cache_hits,
        "cache_misses": res.cache_misses,
        "token_cache_hits": res.token_cache_hits,
        "token_cache_misses": res.token_cache_misses,
    }
    return meta, payload


def unpack_shard_result(meta: dict, payload: memoryview) -> ShardResult:
    """Caller-side inverse of :func:`pack_shard_result`; ``payload`` is a
    shared-memory view. Copy of ``repro/core/executor.py:1457``."""
    res = ShardResult(
        _unpack_columns(payload, meta["columns"]),
        parse_s=meta["parse_s"],
        pre_clean_s=meta["pre_clean_s"],
        clean_s=meta["clean_s"],
        post_clean_s=meta["post_clean_s"],
        tokenize_s=meta.get("tokenize_s", 0.0),
        cache_hits=meta["cache_hits"],
        cache_misses=meta["cache_misses"],
        token_cache_hits=meta.get("token_cache_hits", 0),
        token_cache_misses=meta.get("token_cache_misses", 0),
    )
    res.tokens = _unpack_tokens(payload, meta.get("tokens", []))
    counts = meta.get("word_counts")
    res.word_counts = Counter(counts) if counts is not None else None
    return res


def _out_seg_name(run_id: str, task_id: int) -> str:
    """Deterministic name for a worker's output segment: the caller can
    sweep orphans left by a worker that died between creating the segment
    and delivering its name (SIGKILL, OOM) without ever learning the name
    from the worker. Copy of ``repro/core/executor.py:1478``, with the
    port's prefix."""
    return f"repro_torch_{run_id}_{task_id}"


def _unlink_segment(name: str) -> None:
    """Unlink a segment by name without mapping it: a worker SIGKILLed
    between ``shm_open`` and ``ftruncate`` inside ``SharedMemory(create=
    True)`` leaves an empty segment, which cannot be mapped (``ValueError:
    cannot mmap an empty file``). The resource tracker ends as
    ``SharedMemory(name).unlink()`` leaves it: the name is registered
    (a no-op where the creating worker did) and then unregistered.
    ``repro/core/executor.py:1486`` maps the segment first."""
    import _posixshmem
    from multiprocessing import resource_tracker

    path = "/" + name
    try:
        _posixshmem.shm_unlink(path)
    except FileNotFoundError:
        return
    resource_tracker.register(path, "shared_memory")
    resource_tracker.unregister(path, "shared_memory")


def _bind_device(program: ShardProgram) -> dict[str, int] | None:
    """Under the ``device`` backend: make ``program.device`` this worker's
    current device and return the text kernels' launch counters, whose
    growth the worker reports with each result. None under a host backend,
    whose worker never imports torch. Raises when the program's device is
    a card this process cannot see: no scan falls back to the host."""
    if program.backend != "device":
        return None
    import torch

    from ..device import resolve
    from ..kernels.text_clean import ops as clean_ops

    device = resolve(program.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"shard worker {os.getpid()}: the program scans on {device}, and this "
                "process sees no CUDA device"
            )
        if device.index is not None:
            torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # the workers are the parallelism on the host
    return clean_ops.LAUNCHES


def _worker_main(task_q, result_q, program: ShardProgram, cache_dir, run_id) -> None:
    """Worker process: pull (task_id, shm_name, meta, digest, row_take)
    tasks until sentinel. ``meta`` is the byte count of the shared-memory
    segment — or, when ``shm_name`` is None (feeder's fully-cached fast
    path, no shm copy made), the shard's file path for the rare fallback
    re-read (an entry vanished or corrupted between probe and load).
    ``row_take`` is the shard's canonical-survivor rows for a
    ``dedup_take`` program (None otherwise). Under the ``device`` backend
    the worker binds the program's device before the first shard whose
    steps it runs (a shard served from the cache needs no card), each
    result carries the text kernels' launches it made, and a worker whose
    caller died stops instead of waiting for tasks. Copy of
    ``repro/core/executor.py:1497``."""
    from multiprocessing import shared_memory

    ctx = ProgramContext(program, cache_dir)
    bound: dict = {}  # "counters": the kernels' counters once bound, "mark": as last reported

    def bind() -> None:
        if "counters" not in bound:
            counters = _bind_device(program)
            bound.update(counters=counters, mark=dict(counters or {}))

    parent = mp.parent_process()
    while True:
        try:
            task = task_q.get(timeout=1.0)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                break  # the caller died: no one will read a result
            continue
        if task is None:
            break
        task_id, shm_name, meta, digest, row_take = task
        out = None
        delivered = False
        try:
            if shm_name is None:
                data, path = None, meta
            else:
                path = None
                seg = shared_memory.SharedMemory(name=shm_name)
                try:
                    data = bytes(seg.buf[:meta])
                finally:
                    seg.close()
            res = ctx.run(data, path, digest, row_take, before_steps=bind)
            body, payload = pack_shard_result(res, token_space=ctx.token_space)
            counters = bound.get("counters") or {}
            body["launches"] = {k: n - bound["mark"][k] for k, n in counters.items()
                                if n != bound["mark"][k]}
            if counters:
                bound["mark"] = dict(counters)
            name = _out_seg_name(run_id, task_id)
            try:
                out = shared_memory.SharedMemory(
                    create=True, size=max(len(payload), 1), name=name
                )
            except FileExistsError:
                # Stale block from a crashed earlier run that collided on
                # the id: reclaim it.
                _unlink_segment(name)
                out = shared_memory.SharedMemory(
                    create=True, size=max(len(payload), 1), name=name
                )
            out.buf[: len(payload)] = payload
            body["shm"] = out.name
            out.close()
            result_q.put(("ok", task_id, body))
            delivered = True
        except Exception:  # an interrupt ends the worker; the caller sees its exit code
            result_q.put(("err", task_id, traceback.format_exc()))
        finally:
            if out is not None and not delivered:
                # The caller never learned this segment's name; unlink it
                # here or the block outlives the run.
                try:
                    out.unlink()
                except FileNotFoundError:
                    pass


class ProcessShardExecutor:
    """Spawned worker processes pulling shards from a shared queue (work
    stealing).

    Transport is shared memory in both directions: the feeder thread reads
    each shard once (digesting as it reads), places the raw bytes in a
    segment, and workers return cleaned flat column buffers + row offsets
    in a segment of their own. In-flight shards are bounded so the feeder
    never races ahead of slow consumers. Every wait is bounded: a worker
    that dies fails the run with its exit code.

    Under the ``device`` backend the kernel library is built here, once,
    before any worker starts; each worker then runs its scans on
    ``program.device`` and reports its launches, which are added to this
    process's counters. Copy of ``repro/core/executor.py:1556``.
    """

    name = "process"

    def __init__(
        self,
        shards: Sequence[str | Path],
        program: ShardProgram,
        *,
        workers: int = 2,
        cache_dir: str | Path | None = None,
        max_inflight: int | None = None,
        row_filters: dict[int, np.ndarray] | None = None,
    ):
        if program.has_dedup:
            raise UnsupportedPlanError(
                "drop_duplicates needs cross-shard state; use the thread executor"
            )
        self._row_filters = row_filters
        self.program = program
        self.cache_hits = 0
        self.cache_misses = 0
        self.token_cache_hits = 0
        self.token_cache_misses = 0
        self._parse_s = self._pre_s = self._clean_s = self._post_s = 0.0
        self._tokenize_s = 0.0
        # Caller-side fast-path probe state: when every token-space
        # product of a shard already sits in the cache, the feeder skips
        # the shared-memory copy (workers load straight from disk).
        self._cache = ShardCache(cache_dir) if cache_dir is not None else None
        self._token_fps = token_fingerprints(program) if self._cache else None
        self._count_fp = count_fingerprint(program) if self._cache else None
        self._dedup_fp = dedup_keys_fingerprint(program) if self._cache else None
        self._shards = [Path(s) for s in shards]
        self._stopped = threading.Event()
        self._feed_errors: list[Exception] = []
        self._inflight = threading.Semaphore(max_inflight or max(2 * workers, 4))
        self._in_segs: dict[int, str] = {}
        self._seg_lock = threading.Lock()
        # Segment-leak bookkeeping: output segments carry deterministic
        # names derived from this run id, and every task whose output the
        # caller already unlinked lands in _consumed — so the sweep in
        # stop() (and the atexit last resort) can unlink exactly the
        # blocks a killed worker orphaned.
        self.run_id = f"{os.getpid():x}x{os.urandom(4).hex()}"
        self._consumed: set[int] = set()
        if program.backend == "device":
            _build_kernels_for(program)
        atexit.register(self._sweep_segments)
        # Start the resource tracker before the first worker: spawned
        # workers share it, or unlinking a segment a worker created is
        # reported as a leak at shutdown.
        shared_memory_available()
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(self._task_q, self._result_q, program, cache_dir, self.run_id),
                daemon=True,
            )
            for _ in range(max(int(workers), 1))
        ]
        for p in self._procs:
            p.start()
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _feed(self) -> None:
        from multiprocessing import shared_memory

        try:
            for i, path in enumerate(self._shards):
                while not self._inflight.acquire(timeout=0.1):
                    if self._stopped.is_set():
                        return
                if self._stopped.is_set():
                    return
                data, digest = ing.read_shard_bytes(path)
                row_take = (
                    self._row_filters.get(i)
                    if self._row_filters is not None
                    else None
                )
                if products_fully_cached(
                    self.program, self._cache, self._token_fps,
                    self._count_fp, digest, self._dedup_fp,
                ):
                    # Fully cached: no shm copy; ship the path so the
                    # worker can fall back to its own read if an entry
                    # vanishes between this probe and its load.
                    self._task_q.put((i, None, str(path), digest, row_take))
                    continue
                seg = shared_memory.SharedMemory(create=True, size=max(len(data), 1))
                seg.buf[: len(data)] = data
                with self._seg_lock:
                    self._in_segs[i] = seg.name
                self._task_q.put((i, seg.name, len(data), digest, row_take))
                seg.close()
        except Exception as e:  # deleted shard, /dev/shm full, ...
            # Surface the real cause to the consumer; without this the
            # consumer only sees "workers exited before delivering".
            self._feed_errors.append(e)
        finally:
            for _ in self._procs:
                self._task_q.put(None)

    def _release_input(self, task_id: int) -> None:
        with self._seg_lock:
            name = self._in_segs.pop(task_id, None)
        if name is not None:
            _unlink_segment(name)

    def _next_result(self):
        """Result-queue get that notices dead workers instead of blocking
        forever (an OOM-killed or segfaulted worker never sends its
        result)."""
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue.Empty:
                if self._feed_errors:
                    raise self._feed_errors[0]
                crashed = [
                    p.exitcode
                    for p in self._procs
                    if not p.is_alive() and p.exitcode not in (0, None)
                ]
                if crashed:
                    raise RuntimeError(
                        f"shard worker died with exit code {crashed[0]} "
                        "(no result for its shard)"
                    )
                if all(not p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        "all shard workers exited before delivering every result"
                    )

    def __iter__(self) -> Iterator[ShardResult]:
        from multiprocessing import shared_memory

        for _ in range(len(self._shards)):
            if self._stopped.is_set():
                return
            try:
                msg = self._next_result()
            except BaseException:
                self.stop()
                raise
            status, task_id, body = msg
            self._release_input(task_id)
            self._inflight.release()
            if status == "err":
                self._consumed.add(task_id)  # worker unlinked its own block
                self.stop()
                raise RuntimeError(f"shard worker failed:\n{body}")
            seg = shared_memory.SharedMemory(name=body["shm"])
            try:
                view = seg.buf[: body["size"]]
                res = unpack_shard_result(body, view)
                del view  # release the exported buffer before closing
            finally:
                seg.close()
                seg.unlink()
                self._consumed.add(task_id)
            if body["launches"]:
                from ..kernels.text_clean import ops as clean_ops

                clean_ops.add_launches(body["launches"])
            self._parse_s += res.parse_s
            self._pre_s += res.pre_clean_s
            self._clean_s += res.clean_s
            self._post_s += res.post_clean_s
            self._tokenize_s += res.tokenize_s
            self.cache_hits += res.cache_hits
            self.cache_misses += res.cache_misses
            self.token_cache_hits += res.token_cache_hits
            self.token_cache_misses += res.token_cache_misses
            res.shard_index = task_id
            yield res

    @property
    def timings(self):
        from .plan import StageTimings

        return StageTimings(
            self._parse_s, self._pre_s, self._clean_s, self._post_s, self._tokenize_s
        )

    def _drain_results(self) -> None:
        while True:
            try:
                status, task_id, body = self._result_q.get_nowait()
            except queue.Empty:
                return
            if status == "ok":
                _unlink_segment(body["shm"])
            self._consumed.add(task_id)
            self._release_input(task_id)

    def _sweep_segments(self) -> None:
        """Unlink every shared-memory block this run may still own: feeder
        input segments not yet released, and any deterministically-named
        worker output segment whose result the caller never consumed (a
        SIGKILLed worker can orphan one between creating the block and
        delivering its name). Runs from stop() and, as a last resort, from
        an atexit hook, so even an abandoned executor cannot leak."""
        with self._seg_lock:
            leftover = list(self._in_segs.values())
            self._in_segs.clear()
        for name in leftover:
            _unlink_segment(name)
        for i in range(len(self._shards)):
            if i not in self._consumed:
                _unlink_segment(_out_seg_name(self.run_id, i))

    def stop(self) -> None:
        """Abandon remaining shards; safe after breaking out early.
        Idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._inflight.release()  # unblock a parked feeder
        self._feeder.join(timeout=5.0)
        # Abandon queued tasks so workers reach their sentinels quickly
        # (the feeder's sentinels sit behind them in the queue).
        while True:
            try:
                task = self._task_q.get_nowait()
            except queue.Empty:
                break
            if task is not None:
                self._release_input(task[0])
        for _ in self._procs:
            self._task_q.put(None)
        self._drain_results()
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        # Results a worker managed to emit between the drains above, then
        # every block that can still be ours (inputs + orphaned outputs).
        self._drain_results()
        self._sweep_segments()
        for q in (self._task_q, self._result_q):
            q.close()
            q.cancel_join_thread()  # nothing left to deliver; never block exit
        atexit.unregister(self._sweep_segments)


def _build_kernels_for(program: ShardProgram) -> None:
    """Build the kernel library once, before any worker starts, when the
    program's scans run on a card: each worker then loads the cached
    build instead of compiling it beside the others."""
    from ..device import resolve

    if resolve(program.device).type == "cuda":
        from ..kernels import _build

        _build.library()


# ---------------------------------------------------------------------------
# Executor selection
# ---------------------------------------------------------------------------


def _picklable(program: ShardProgram) -> bool:
    try:
        pickle.dumps(program)
    except (pickle.PicklingError, AttributeError, TypeError):
        return False
    return True


def make_executor(
    shards: Sequence[str | Path],
    program: ShardProgram,
    *,
    workers: int = 2,
    cache_dir: str | Path | None = None,
    executor: str | None = None,
    row_filters: dict[int, np.ndarray] | None = None,
    remote: Any = None,
):
    """Pick the physical shard executor.

    Explicit ``executor`` wins, then ``REPRO_EXECUTOR``, then the default:
    processes when ``workers > 1``, threads otherwise. Requests for the
    process executor fall back to threads — never error — when the program
    needs cross-shard dedup state, the platform lacks shared memory,
    ``workers <= 1``, the default choice lands on one core, or the program
    does not pickle (a lambda word predicate: workers are spawned, so the
    program travels pickled).

    ``executor="remote"`` (or ``REPRO_EXECUTOR=remote``) runs shards on
    the remote data plane, a coordinator leasing shards to TCP worker
    processes (:mod:`repro_torch.distributed.coordinator`); ``remote``
    carries its options (see :class:`RemoteShardExecutor`). Like the
    process executor it falls back to threads for cross-shard dedup
    programs and unpicklable programs.
    Copy of ``repro/core/executor.py:1824``, whose pickle check applies
    on spawn-only platforms, which the port's always-spawning executor
    makes every platform."""
    choice = EngineConfig(executor=executor).resolve_executor()
    explicit = bool(choice)
    if not choice:
        choice = "process" if workers > 1 else "thread"
    if choice == "remote":
        if program.has_dedup or not _picklable(program):
            choice = "thread"
        else:
            from ..distributed.coordinator import RemoteShardExecutor

            return RemoteShardExecutor(
                shards,
                program,
                workers=max(int(workers), 1),
                cache_dir=cache_dir,
                row_filters=row_filters,
                remote=remote,
            )
    # More worker processes than cores only adds spawn + scheduling cost;
    # clamp (the thread pool is unclamped — its readers overlap blocking
    # I/O, not CPU). When the *default* selection lands on one effective
    # worker the process executor is pure overhead, so fall back to
    # threads — but an explicit request (argument or REPRO_EXECUTOR) is
    # honored even on one core.
    n_proc = max(min(workers, os.cpu_count() or workers), 1)
    if choice == "process" and (
        workers <= 1
        or program.has_dedup
        or not shared_memory_available()
        or (n_proc <= 1 and not explicit)
        or not _picklable(program)
    ):
        choice = "thread"
    if choice == "process":
        return ProcessShardExecutor(
            shards, program, workers=n_proc, cache_dir=cache_dir,
            row_filters=row_filters,
        )
    return ThreadShardExecutor(
        shards, program, workers=workers, cache_dir=cache_dir,
        row_filters=row_filters,
    )
