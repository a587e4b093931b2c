"""The in-process shard executor and the plan-fingerprint shard cache.

Copy of the in-process half of ``repro/core/executor.py``
(``:78-1233``, ``:1349-1421``, ``:1824-1906``):

* :class:`ShardProgram`: the per-shard physical program compiled from the
  frame-level plan (parse -> select/dropna/filter[/dedup] -> per-column
  compiled expressions -> token encoding or word counting). ``filter``
  steps evaluate predicates to row masks straight off the flat buffers.
* :class:`ThreadShardExecutor`: a work-stealing
  :class:`~repro_torch.core.async_loader.ShardPool` of reader threads,
  each running the whole program per shard; it holds the cross-shard
  ``drop_duplicates`` state. Under the ``device`` backend its threads send
  their scan passes to the card from this one process.
* :class:`ShardCache`: the ``persist()`` analogue, an on-disk cache of
  cleaned column buffers, token arrays and word counts keyed by (shard
  bytes digest, column lineage fingerprint). Writes are atomic (a temp
  file, then ``os.replace``); a malformed entry is a miss, never an error.

Where the port differs. Every fingerprint and cache key carries the port's
tag (``bytesops.PORT_TAG``) and the default cache root is
``<tempdir>/repro_torch_shard_cache``: both packages read
``REPRO_CACHE_DIR``, and neither ever reads the other's entries. The
program carries the ``device`` of the ``device`` backend's scan passes,
resolved by the caller's thread (the card unless the caller names another).
:func:`make_executor` makes the thread executor at any worker count;
``executor="process"`` and ``"remote"`` raise: the process executor with
its shared-memory packing (``executor.py:1235-1823``) and the remote one
are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import tempfile
import threading
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

from . import bytesops as B
from . import expr as E
from . import ingest as ing
from ..data.batching import TokenSpec, VocabTable, encode_flat, encode_rows
from ..device import resolve
from .async_loader import ShardPool
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
    return ShardProgram(
        tuple(src.fields),
        tuple(steps),
        tuple(output_columns),
        tokens=tokens,
        count_words=tuple(count_words),
        backend=backend,
        device=str(resolve(device)) if backend == "device" else None,
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


def program_fingerprint(program: ShardProgram) -> str:
    """Content fingerprint of a compiled shard program, port-tagged (the
    reference's remote data plane keys result dedup on it). Copy of
    ``repro/core/executor.py:1349``."""
    return hashlib.blake2b(
        B.PORT_TAG + pickle.dumps(program, protocol=4), digest_size=16
    ).hexdigest()


class ProgramContext:
    """Per-process execution state for one compiled program: the shard
    cache handle plus every derived fingerprint, computed once per worker
    instead of once per shard. The reference's process and remote workers
    drive shards through :meth:`run`; in the port it runs one shard in the
    calling thread. Copy of
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
    ) -> ShardResult:
        """Execute the program on one shard: serve fully-cached products
        without parsing when possible, else parse ``data`` (read from
        ``path`` when ``data`` is None — the fully-cached fast path's rare
        fallback) and run every step. Wall time not attributed to a
        specific stage lands in ``parse_s``."""
        t0 = time.perf_counter()
        res = _load_cached_products(
            self.program, self.cache, self.token_fps, self.count_fp, digest,
            self.dedup_fp,
        )
        if res is None:
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

# ---------------------------------------------------------------------------
# Executor selection
# ---------------------------------------------------------------------------


def make_executor(
    shards: Sequence[str | Path],
    program: ShardProgram,
    *,
    workers: int = 2,
    cache_dir: str | Path | None = None,
    executor: str | None = None,
    row_filters: dict[int, np.ndarray] | None = None,
    remote: Any = None,
) -> ThreadShardExecutor:
    """The thread shard executor, at any worker count. ``executor`` (then
    ``REPRO_EXECUTOR``) may name ``"thread"`` or nothing; ``"process"``
    and ``"remote"``, and a ``remote`` option, raise ``ValueError``: those
    executors are not ported yet, and running their plans on threads
    instead would hide it. Copy of
    ``repro/core/executor.py:1824``."""
    EngineConfig(executor=executor).resolve_executor()
    if remote is not None:
        EngineConfig(executor="remote").resolve_executor()
    return ThreadShardExecutor(
        shards, program, workers=workers, cache_dir=cache_dir,
        row_filters=row_filters,
    )
