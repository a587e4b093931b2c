"""Lazy, Spark-DataFrame-style ``Dataset``: one declarative plan from JSON
shards to batches on the card.

Copy of ``repro/core/dataset.py``. Chain methods append logical
plan nodes (:mod:`repro_torch.core.plan`); terminals hand the plan to the
planner, which merges ``Project`` nodes and fuses their expression chains,
pushes ``where`` filters and projections toward the source, prunes dead
derived columns, and runs whole-frame or streams per shard::

    keep = col("title").not_empty() & col("abstract").not_empty()
    clean = (Dataset.from_json_dirs([corpus])
             .where(keep).drop_duplicates()
             .transform(abstract=abstract_expr(), title=title_expr())
             .where(keep))
    tok = clean.fit_vocab(vocab_size=8000)       # shard-merged word counts
    feed = (clean
            .tokenize(tok, seq2seq_specs())      # encoded inside the executor
            .batched(32, bucket_by=("encoder_tokens", "decoder_tokens"))
            .prefetch(2)
            .device_batches(overlap=True))       # DeviceFeed on the 2-D grid

Terminals: ``collect()`` / ``to_records()`` / ``execute()`` (whole-frame,
with :class:`~repro_torch.core.plan.StageTimings`), ``fit_vocab()``,
``arrays()``, ``iter_batches()``, ``device_batches()`` and
``row_program()`` (per-request serving). Whole-frame
results are memoized on the frame-level prefix. Every terminal validates
the plan first (:mod:`repro_torch.analysis`).

Where the port differs. The ``device`` backend (the default) runs each scan
pass on ``device``, and ``device_batches`` copies batches to it: the card
unless the chain (``.device(...)``) or the terminal (``device=``) names
another, and without a card both raise. ``.workers(n)`` runs shards on
spawned processes when ``n > 1``, as the reference's forked ones, and
under the ``device`` backend each worker runs its scans on that device,
the remote executor's TCP workers too (``.workers(n, remote=...)``).
``sharding=`` is refused.
"""

from __future__ import annotations

import time
from collections import Counter
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

from ..data.batching import TokenSpec, batches as _array_batches, derive_buckets
from ..data.tokenizer import WordTokenizer
from ..device import resolve
from . import expr as E
from . import plan as P
from .async_loader import AsyncLoader
from .engine_config import EngineConfig
from .frame import ColumnarFrame
from .stages import Stage


class Dataset:
    """Immutable handle on a logical preprocessing plan. Copy of ``repro/core/dataset.py:75``."""

    def __init__(
        self,
        nodes: Sequence[P.PlanNode],
        schema: Sequence[str],
        parent: "Dataset | None" = None,
        options: dict | None = None,
    ):
        self._nodes = tuple(nodes)
        self.schema = tuple(schema)
        self._parent = parent
        self._options = dict(options or {})
        self._frame_cache: dict[tuple, tuple[ColumnarFrame, P.StageTimings]] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_json_dirs(
        cls, directories: Sequence[str | Path], fields: Sequence[str] = ("title", "abstract")
    ) -> "Dataset":
        node = P.SourceJsonDirs(tuple(str(d) for d in directories), tuple(fields))
        return cls([node], fields)

    @classmethod
    def from_frame(cls, frame: ColumnarFrame) -> "Dataset":
        return cls([P.SourceFrame(frame)], frame.field_names)

    @classmethod
    def from_records(cls, records: Sequence[dict], fields: Sequence[str]) -> "Dataset":
        return cls.from_frame(ColumnarFrame.from_records(records, fields))

    # -- plan verbs (lazy) -------------------------------------------------
    def _derive(self, node: P.PlanNode, schema: Sequence[str]) -> "Dataset":
        if not P.is_frame_node(node):
            pass  # array-level nodes may follow anything below
        elif any(not P.is_frame_node(n) for n in self._nodes):
            raise ValueError(
                f"{type(node).__name__} is frame-level and must come before "
                "tokenize/batch/prefetch"
            )
        return Dataset(self._nodes + (node,), schema, parent=self, options=self._options)

    def _resolve_subset(self, subset: Sequence[str] | None) -> tuple[str, ...]:
        cols = tuple(subset) if subset is not None else self.schema
        unknown = [c for c in cols if c not in self.schema]
        if unknown:
            raise KeyError(f"unknown columns {unknown}; schema is {list(self.schema)}")
        return cols

    def select(self, fields: Sequence[str]) -> "Dataset":
        fields = self._resolve_subset(fields)
        return self._derive(P.Select(fields), fields)

    def dropna(self, subset: Sequence[str] | None = None) -> "Dataset":
        return self._derive(P.DropNA(self._resolve_subset(subset)), self.schema)

    def drop_duplicates(self, subset: Sequence[str] | None = None) -> "Dataset":
        return self._derive(P.DropDuplicates(self._resolve_subset(subset)), self.schema)

    def _check_expr_inputs(self, e, what: str, schema: Sequence[str]) -> None:
        unknown = sorted(e.inputs() - set(schema))
        if unknown:
            raise KeyError(
                f"{what} reads unknown columns {unknown}; schema is {list(schema)}"
            )

    def with_column(self, name: str, expression: E.Expr) -> "Dataset":
        """Derive (or overwrite) one column from a composable expression::

            ds.with_column("abstract", col("abstract").lower().strip_html())
            ds.with_column("text", concat(col("title"), col("abstract")))
        """
        if not isinstance(expression, E.Expr):
            raise TypeError(f"with_column() needs an expression, got {expression!r}")
        self._check_expr_inputs(expression, f"with_column({name!r})", self.schema)
        schema = list(self.schema)
        if name not in schema:
            schema.append(name)
        return self._derive(P.Project(((name, expression),)), schema)

    def transform(self, **expressions: E.Expr) -> "Dataset":
        """Several :meth:`with_column` steps as one ``Project`` node;
        entries evaluate in keyword order, each seeing the previous ones::

            ds.transform(abstract=abstract_expr(), title=title_expr())
        """
        if not expressions:
            return self
        schema = list(self.schema)
        entries = []
        for name, e in expressions.items():
            if not isinstance(e, E.Expr):
                raise TypeError(f"transform({name}=...) needs an expression, got {e!r}")
            self._check_expr_inputs(e, f"transform({name}=...)", schema)
            entries.append((name, e))
            if name not in schema:
                schema.append(name)
        return self._derive(P.Project(tuple(entries)), schema)

    def where(self, pred: E.Pred) -> "Dataset":
        """Keep rows satisfying a byte-buffer predicate::

            ds.where(col("abstract").word_count() >= 5)
            ds.where(col("title").not_empty() & ~col("title").contains("retracted"))

        The optimizer pushes the filter back toward the source past any
        ``Project`` that does not write a column it reads, so filtered
        rows are never cleaned (generalized dropna pullback).
        """
        if isinstance(pred, E.WordCount):
            raise TypeError("where() needs a predicate; compare word_count() to an int")
        if not isinstance(pred, E.Pred):
            raise TypeError(f"where() needs a predicate expression, got {pred!r}")
        self._check_expr_inputs(pred, "where(...)", self.schema)
        return self._derive(P.Filter(pred), self.schema)

    def apply(self, *stages: Stage) -> "Dataset":
        """Deprecated shim: lower legacy ``Stage`` verbs to their
        expressions (one ``Project`` node; see ``stages.Stage.to_expr``).
        Byte-identical to composing the expressions directly."""
        if not stages:
            return self
        schema = list(self.schema)
        entries = []
        for s in stages:
            if s.input_col not in schema:
                raise KeyError(
                    f"stage {type(s).__name__} reads unknown column {s.input_col!r}"
                )
            entries.append((s.output_col, s.to_expr(E.col(s.input_col))))
            if s.output_col not in schema:
                schema.append(s.output_col)
        return self._derive(P.Project(tuple(entries)), schema)

    def split(self, val_fraction: float = 0.1, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """(train, val) datasets over a deterministic row partition."""
        train = self._derive(P.Split(val_fraction, seed, "train"), self.schema)
        val = self._derive(P.Split(val_fraction, seed, "val"), self.schema)
        return train, val

    def tokenize(
        self,
        tokenizer: Any,
        specs: Sequence[TokenSpec] | None = None,
        *,
        col: str | None = None,
        max_len: int = 128,
        add_start_end: bool = False,
    ) -> "Dataset":
        """Attach token encoding: either explicit ``specs`` or one ``col``."""
        if specs is None:
            if col is None:
                raise ValueError("tokenize() needs specs=... or col=...")
            specs = (TokenSpec(col, max_len, add_start_end=add_start_end),)
        specs = tuple(specs)
        for spec in specs:
            if spec.column not in self.schema:
                raise KeyError(f"tokenize spec reads unknown column {spec.column!r}")
        return self._derive(P.Tokenize(tokenizer, specs), [s.name for s in specs])

    # -- vocabulary fitting (terminal; Spark CountVectorizer-style) --------
    def _counts_mode(self) -> str:
        """How ``fit_vocab`` counts: ``"stream"`` (one pass through the
        shard executors), ``"two-pass"`` (canonical-survivor dedup
        election, then a counting pass over the survivors — the streaming
        protocol for partial-subset ``drop_duplicates``), or ``"whole"``
        (count the materialized frame)."""
        owner = self._frame_prefix_dataset()
        if self._has_memoized_frame():
            return "whole"  # already materialized: count that frame
        if not isinstance(owner._nodes[0], P.SourceJsonDirs):
            return "whole"
        if any(isinstance(n, P.Split) for n in owner._nodes):
            return "whole"  # whole-frame only
        src_fields = set(owner._nodes[0].fields)
        dedups = [n for n in owner._nodes if isinstance(n, P.DropDuplicates)]
        partial = [d for d in dedups if not set(d.subset) >= src_fields]
        if not partial:
            return "stream"  # full-subset dedup: duplicate rows interchange
        if len(dedups) == 1:
            return "two-pass"
        # A partial-subset dedup stacked with another dedup: the election
        # pass would itself run under scheduling-dependent cross-shard
        # state, so fall back to the exact whole-frame count.
        return "whole"

    def fit_vocab(
        self,
        columns: Sequence[str] | None = None,
        vocab_size: int = 8000,
        *,
        workers: int | None = None,
        optimize: bool = True,
        executor: str | None = None,
        stats: dict | None = None,
        device=None,
    ) -> WordTokenizer:
        """Fit a :class:`WordTokenizer` on the cleaned text of ``columns``
        (default: every frame column) — the fit half of the Spark
        fit-then-transform split.

        On an unmaterialized JSON source this runs as a per-shard word
        ``Counter`` inside the shard executors (thread or process, same
        selection rules as streaming batches) merged by the caller, so
        fitting never makes a second caller-side pass over the corpus;
        otherwise it counts the memoized whole frame. Both orders produce
        the identical vocabulary: counter merge is commutative and the
        ranking tie-break is deterministic (count desc, word asc). With
        the shard cache enabled, per-shard counts are cached too — a
        refit over unchanged data and plan reads no shard at all.

        Plans with a partial-subset ``drop_duplicates`` stream too, via
        the two-pass canonical-survivor protocol: pass 1 emits per-row
        dedup-key digests, the caller elects each key's first occurrence
        in deterministic ``(shard, row)`` order, and pass 2 counts only
        the elected survivors — byte-identical to the whole-frame fit on
        every executor (see :func:`repro_torch.core.executor.split_dedup_programs`).
        ``device`` is where the ``device`` backend's scan passes run."""
        from . import executor as EX
        from . import ingest as ing

        owner = self._frame_prefix_dataset()
        # Validate the frame prefix before any executor spawns. Never with
        # the streaming shape checks: fit_vocab falls back to the exact
        # whole-frame count for plans that cannot stream (see _counts_mode).
        owner._require_valid(streaming=False, optimize=optimize)
        cols = tuple(columns) if columns is not None else owner.schema
        unknown = [c for c in cols if c not in owner.schema]
        if unknown:
            raise KeyError(f"unknown columns {unknown}; schema is {list(owner.schema)}")
        counts: Counter = Counter()
        n_workers = self._resolve_workers(workers, default=2)
        mode = self._counts_mode()
        device = self._scan_device(device)
        if mode != "whole":
            frame_nodes, _ = P.split_plan(owner._nodes)
            if optimize:
                frame_nodes = P.optimize_plan(frame_nodes, cols)
            exec_kw = dict(
                workers=n_workers,
                cache_dir=self._resolve_cache_dir(),
                executor=executor or self._options.get("executor"),
                remote=self._options.get("remote"),
            )
            shards = ing.list_shards(frame_nodes[0].directories)
            row_filters = None
            if mode == "two-pass":
                pass1, program = EX.split_dedup_programs(
                    frame_nodes, optimize=optimize, count_columns=cols,
                    backend=self._resolve_backend(), device=device,
                )
                row_filters = self._elect_survivors(
                    shards, pass1, exec_kw, stats
                )
            else:
                program = EX.compile_shard_program(
                    frame_nodes, optimize=optimize, output_columns=cols,
                    count_words=cols, backend=self._resolve_backend(), device=device,
                )
            exec_ = EX.make_executor(
                shards, program, row_filters=row_filters, **exec_kw
            )
            try:
                for res in exec_:
                    if res.word_counts:
                        counts.update(res.word_counts)
            finally:
                exec_.stop()
                if stats is not None:
                    stats["executor"] = exec_.name
                    stats["two_pass"] = mode == "two-pass"
                    stats["token_cache_hits"] = (
                        stats.get("token_cache_hits", 0) + exec_.token_cache_hits
                    )
                    stats["token_cache_misses"] = (
                        stats.get("token_cache_misses", 0) + exec_.token_cache_misses
                    )
                    stats["timings"] = exec_.timings
        else:
            frame, _ = owner._materialize(
                self._resolve_workers(workers), optimize, exact=workers is not None,
                device=device,
            )
            if stats is not None:
                stats["executor"] = "whole-frame"
            for col in cols:
                for t in frame[col]:
                    counts.update((t or "").split())
        return WordTokenizer.from_counts(counts, vocab_size)

    def _elect_survivors(
        self, shards, pass1, exec_kw: dict, stats: dict | None
    ) -> dict[int, np.ndarray]:
        """Pass 1 of two-pass dedup: the shared
        :func:`repro_torch.core.executor.elect_survivors`."""
        from . import executor as EX

        return EX.elect_survivors(shards, pass1, exec_kw, stats)

    def _resolve_bucket_widths(
        self, spec: TokenSpec, widths: Sequence[int] | None, n_buckets: int
    ) -> tuple[int, ...]:
        if not widths:
            return derive_buckets(spec.max_len, n_buckets)
        resolved = tuple(sorted({int(b) for b in widths}))
        if resolved[0] < 1:
            raise ValueError(f"bucket widths must be >= 1, got {resolved}")
        if resolved[-1] < spec.max_len:
            # The last bucket must fit any row (rows were already
            # truncated to max_len by encoding).
            resolved = resolved + (spec.max_len,)
        return resolved

    def batch(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        pad_to: int | None = None,
        bucket_by: str | Sequence[str] | None = None,
        buckets: Sequence | None = None,
        n_buckets: int = 4,
    ) -> "Dataset":
        """Fixed-shape batches. With ``bucket_by`` (a token output name, or
        several), rows are grouped by payload length into a small fixed
        set of bucket widths — ``buckets`` explicitly, else ``n_buckets``
        linear steps up to each spec's ``max_len`` — and each bucketed
        column is sliced to its bucket width, so short rows stop paying
        full-width padding while jit still sees a bounded shape set.
        ``bucket_by=("encoder_tokens", "decoder_tokens")`` builds the 2-D
        grid (paired bucketing: decoder padding drops too); pass nested
        ``buckets`` (one width list per column) to pin the grid."""
        tok = next((n for n in self._nodes if isinstance(n, P.Tokenize)), None)
        if tok is None:
            raise ValueError("batch() requires .tokenize(...) earlier in the chain")
        if buckets and bucket_by is None:
            raise ValueError(
                "buckets=... needs bucket_by=<token output name(s)>; without "
                "it the batches would silently stay fixed-max_len"
            )
        bb: str | tuple[str, ...] | None = bucket_by if isinstance(
            bucket_by, (str, type(None))
        ) else tuple(bucket_by)
        resolved: tuple = ()
        if bb is not None:
            from ..data.batching import bucket_columns

            cols = bucket_columns(bb)
            specs_by_name = {s.name: s for s in tok.specs}
            for c in cols:
                if c not in specs_by_name:
                    raise KeyError(
                        f"bucket_by={c!r} is not a token output; "
                        f"available: {[s.name for s in tok.specs]}"
                    )
            if buckets and not isinstance(buckets[0], (int, np.integer)):
                if len(buckets) != len(cols):
                    raise ValueError(
                        f"{len(buckets)} bucket width lists for "
                        f"{len(cols)} bucket columns"
                    )
                per_col: Sequence[Sequence[int] | None] = list(buckets)
            else:
                if buckets and len(cols) != 1:
                    raise ValueError(
                        "flat buckets=... with several bucket_by columns; "
                        "pass one width list per column"
                    )
                per_col = [buckets] + [None] * (len(cols) - 1)
            widths = tuple(
                self._resolve_bucket_widths(specs_by_name[c], w, n_buckets)
                for c, w in zip(cols, per_col)
            )
            resolved = widths[0] if isinstance(bb, str) else widths
        node = P.Batch(
            batch_size, shuffle, seed, drop_remainder, pad_to, bb, resolved
        )
        return self._derive(node, self.schema)

    def batched(self, batch_size: int, **kwargs: Any) -> "Dataset":
        """Alias of :meth:`batch` — the bucketed-assembly verb
        (``.batched(32, bucket_by=("encoder_tokens", "decoder_tokens"))``)."""
        return self.batch(batch_size, **kwargs)

    def prefetch(self, prefetch: int = 2, *, sharding: Any = None) -> "Dataset":
        """Declare streaming intent: terminal batch iteration runs per-shard
        over a work-stealing pool and feeds AsyncLoader with this depth."""
        return self._derive(P.Prefetch(prefetch, sharding), self.schema)

    # -- execution options (lazy; no plan nodes) ---------------------------
    def _with_options(self, **options: Any) -> "Dataset":
        # parent=self: the new handle shares this dataset's position in the
        # memoization chain, so adding options after a terminal still
        # resumes from the already-materialized frame (empty suffix).
        return Dataset(
            self._nodes, self.schema, parent=self,
            options={**self._options, **options},
        )

    def workers(
        self,
        n: int,
        *,
        executor: str | None = None,
        remote: Any = None,
    ) -> "Dataset":
        """Default worker count for every terminal of this chain (and, for
        streaming terminals, which physical executor runs the shards:
        ``"thread"``/``"process"``/``"remote"``; default picks processes
        when ``n > 1``). Passing ``remote=...`` (True or an options dict,
        see :class:`repro_torch.distributed.coordinator.RemoteShardExecutor`)
        selects the remote data plane: a coordinator leasing shards to
        ``n`` TCP worker processes with heartbeat liveness and
        restart-safe reassignment. Copy of
        ``repro/core/dataset.py:475``."""
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {n}")
        opts: dict[str, Any] = {"workers": int(n)}
        if remote is not None:
            opts["remote"] = remote
            if executor is None:
                executor = "remote"
        EngineConfig(executor=executor).resolve_executor()  # an unknown name raises here
        if executor is not None:
            opts["executor"] = executor
        return self._with_options(**opts)

    def cache(self, directory: str | Path | bool = True) -> "Dataset":
        """Enable the on-disk plan-fingerprint shard cache for streaming
        terminals (the Spark ``persist()`` analogue). ``True`` uses
        ``REPRO_CACHE_DIR`` or the system temp dir; a path pins the cache
        root. ``False`` disables a previously enabled cache."""
        from .executor import default_cache_dir

        if directory is False:
            return self._with_options(cache_dir=None)
        root = default_cache_dir() if directory is True else Path(directory)
        return self._with_options(cache_dir=root)

    def backend(self, name: str) -> "Dataset":
        """Select the byte backend compiled into this chain's programs:
        ``"loops"`` (per-op passes), ``"fused"`` (the megapass on the host)
        or ``"device"`` (the megapass with its scan passes on the card's
        ``text_scan`` kernel). Outputs are the same bytes under each, so
        shard-cache keys and memoized frames are shared across backends.
        Default: ``REPRO_BYTES_BACKEND``, then ``"device"``."""
        from . import bytesops as B

        if name not in B.BACKENDS:
            raise ValueError(f"unknown bytes backend {name!r}; one of {B.BACKENDS}")
        return self._with_options(backend=name)

    def device(self, name) -> "Dataset":
        """The device of this chain's terminals: where the ``device``
        backend's scan passes run and ``device_batches`` puts batches. The
        default is the card; a terminal's own ``device=`` wins."""
        return self._with_options(device=str(name))

    def engine_config(self) -> EngineConfig:
        """This chain's explicit engine options as an
        :class:`~repro_torch.core.engine_config.EngineConfig`; its ``resolve_*``
        methods apply the documented explicit-verb > env > default order."""
        return EngineConfig.from_options(self._options)

    def _resolve_backend(self) -> str | None:
        return self._options.get("backend")

    def _resolve_device(self, explicit=None):
        """The terminal's ``device=``, else the chain's ``.device(...)``;
        None means the card."""
        return explicit if explicit is not None else self._options.get("device")

    def _scan_device(self, explicit=None):
        """Where the scan passes run: resolved (and raising without a card
        unless the CPU is named) under the ``device`` backend, else None."""
        if self.engine_config().resolve_backend() != "device":
            return None
        return resolve(self._resolve_device(explicit))

    def _resolve_cache_dir(self) -> Path | None:
        return self.engine_config().resolve_cache_dir()

    def _resolve_workers(self, explicit: int | None, default: int = 1) -> int:
        return self.engine_config().resolve_workers(explicit, default)

    # -- plan inspection ---------------------------------------------------
    def validate(
        self, *, streaming: bool | None = None, optimize: bool = True
    ) -> list:
        """Statically analyze this plan; returns every
        :class:`repro_torch.analysis.Diagnostic` (empty list = clean).

        Runs typed schema inference and expression type checking over the
        node list, the streaming shape checks when this chain would stream
        (or when ``streaming=True`` forces them), and — with ``optimize``
        — static verification of every optimizer rewrite. Every terminal
        calls this first, so an invalid plan raises a coded,
        provenance-bearing :class:`repro_torch.analysis.PlanValidationError`
        before any executor thread starts."""
        from ..analysis import analyze_plan

        if streaming is None:
            streaming = self._streaming()
        return analyze_plan(
            self._nodes,
            final_schema=self._needed_columns(),
            streaming=streaming,
            optimize=optimize,
        )

    def _require_valid(
        self, *, streaming: bool | None = None, optimize: bool = True
    ) -> None:
        """Raise :class:`repro_torch.analysis.PlanValidationError` on any
        error-severity diagnostic (warnings — e.g. an unfingerprintable
        lambda op — never block execution)."""
        from ..analysis import PlanValidationError

        errors = [
            d
            for d in self.validate(streaming=streaming, optimize=optimize)
            if d.severity == "error"
        ]
        if errors:
            raise PlanValidationError(errors)

    @property
    def plan(self) -> tuple[P.PlanNode, ...]:
        return self._nodes

    def optimized_plan(self) -> list[P.PlanNode]:
        frame_nodes, array_nodes = P.split_plan(self._nodes)
        return P.optimize_plan(frame_nodes, self._needed_columns()) + array_nodes

    def explain(self) -> str:
        return P.explain(
            self._nodes, self._needed_columns(), backend=self._resolve_backend()
        )

    # -- execution helpers -------------------------------------------------
    def _frame_prefix_dataset(self) -> "Dataset":
        """Nearest ancestor whose plan is entirely frame-level."""
        ds: Dataset = self
        while ds._nodes and not P.is_frame_node(ds._nodes[-1]):
            if ds._parent is None:
                # Hand-built Dataset (constructed from raw nodes, no
                # chain ancestry): synthesize the frame prefix so
                # validation and terminals still resolve a frame schema.
                prefix = []
                for n in ds._nodes:
                    if not P.is_frame_node(n):
                        break
                    prefix.append(n)
                return Dataset(prefix, ds.schema, options=ds._options)
            ds = ds._parent
        return ds

    def _frame_schema(self) -> tuple[str, ...]:
        return self._frame_prefix_dataset().schema

    def _needed_columns(self) -> tuple[str, ...]:
        """Columns the terminal actually consumes: with a Tokenize node only
        its spec columns are live, letting the planner project the source
        down to them (streaming path; the whole-frame cache stays full-width
        because it is shared across terminals)."""
        tok = next((n for n in self._nodes if isinstance(n, P.Tokenize)), None)
        if tok is not None:
            return tuple(dict.fromkeys(spec.column for spec in tok.specs))
        return self._frame_schema()

    def _materialize(
        self, workers: int, optimize: bool, exact: bool = False, device=None
    ) -> tuple[ColumnarFrame, P.StageTimings]:
        owner = self._frame_prefix_dataset()
        key = (workers, optimize)

        def lookup(ds: "Dataset"):
            # The frame is worker-count-invariant (only timings differ), so
            # an entry with the same optimize flag is a valid reuse —
            # .workers(n) after a terminal must not force a re-clean. But a
            # caller who passed workers= explicitly (``exact``) is often
            # sweeping worker counts for timings, so only the exact key
            # counts there.
            hit = ds._frame_cache.get(key)
            if hit is None and not exact:
                hit = next(
                    (v for (_, o), v in ds._frame_cache.items() if o == optimize),
                    None,
                )
            return hit

        hit = lookup(owner)
        if hit is not None:
            return hit
        # Resume from the deepest memoized ancestor prefix, if any: a chain
        # like clean.split() then re-runs only the cheap suffix nodes.
        base: tuple[ColumnarFrame, P.StageTimings] | None = None
        base_len = 0
        ds = owner._parent
        while ds is not None:
            cached = lookup(ds)
            if cached is not None:
                base, base_len = cached, len(ds._nodes)
                break
            ds = ds._parent
        device = self._scan_device(device)
        if base is None:
            hit = P.execute_frame_plan(
                owner._nodes, workers=workers, optimize=optimize,
                final_schema=owner.schema, backend=self._resolve_backend(),
                device=device,
            )
        else:
            suffix = owner._nodes[base_len:]
            seen_cleaning = any(
                isinstance(n, P.Project) for n in owner._nodes[:base_len]
            )
            hit = P.continue_frame_plan(
                base[0], base[1], suffix,
                workers=workers, optimize=optimize, seen_cleaning=seen_cleaning,
                backend=self._resolve_backend(), device=device,
            )
        owner._frame_cache[key] = hit
        return hit

    def _array_nodes(self) -> list[P.PlanNode]:
        return [n for n in self._nodes if not P.is_frame_node(n)]

    def _batch_node(self) -> P.Batch:
        node = next((n for n in self._nodes if isinstance(n, P.Batch)), None)
        if node is None:
            raise ValueError("no .batch(...) in the plan")
        return node

    def bucket_grid_spec(self):
        """The fixed :class:`~repro_torch.core.device_pipeline.BucketGrid`
        this plan's batches are assembled on, or None when the plan does not
        bucket (then every batch already has the one ``max_len`` shape):
        the closed shape set ``DeviceFeed`` pads against."""
        from ..data.batching import bucket_columns
        from .device_pipeline import BucketGrid

        batch = self._batch_node()
        if batch.bucket_by is None or not batch.buckets:
            return None
        cols = bucket_columns(batch.bucket_by)
        widths = batch.buckets
        if widths and isinstance(widths[0], (int, np.integer)):
            widths = (widths,)
        return BucketGrid(batch.batch_size, dict(zip(cols, widths)))

    def _has_memoized_frame(self) -> bool:
        """True when this chain's frame prefix is already materialized —
        possibly on an options-hop ancestor sharing the same prefix."""
        owner = self._frame_prefix_dataset()
        ds: Dataset | None = owner
        while ds is not None and len(ds._nodes) == len(owner._nodes):
            if ds._frame_cache:
                return True
            ds = ds._parent
        return False

    def _streaming(self) -> bool:
        if not any(isinstance(n, P.Prefetch) for n in self._nodes):
            return False
        # Already materialized — reuse the frame, don't re-read shards.
        if self._has_memoized_frame():
            return False
        return isinstance(self._nodes[0], P.SourceJsonDirs) and not any(
            isinstance(n, P.Split) for n in self._nodes
        )

    # -- terminal actions --------------------------------------------------
    def collect(
        self, *, workers: int | None = None, optimize: bool = True, device=None
    ) -> ColumnarFrame:
        """Materialize the frame (plan must be frame-level only)."""
        if self._array_nodes():
            raise ValueError("collect() on a tokenized plan; use arrays()/iter_batches()")
        self._require_valid(streaming=False, optimize=optimize)
        return self._materialize(
            self._resolve_workers(workers), optimize, exact=workers is not None,
            device=device,
        )[0]

    def execute(
        self, *, workers: int | None = None, optimize: bool = True, device=None
    ) -> tuple[list[dict], P.StageTimings]:
        """(records, StageTimings) — the legacy ``run_p3sapp`` contract."""
        if self._array_nodes():
            raise ValueError(
                "execute()/to_records() on a tokenized plan; use arrays()/iter_batches()"
            )
        self._require_valid(streaming=False, optimize=optimize)
        frame, t = self._materialize(
            self._resolve_workers(workers), optimize, exact=workers is not None,
            device=device,
        )
        t = P.StageTimings(**{k: getattr(t, k) for k in
                              ("ingestion", "pre_cleaning", "cleaning",
                               "post_cleaning", "tokenize")})
        t0 = time.perf_counter()
        records = frame.to_records()
        t.post_cleaning += time.perf_counter() - t0
        return records, t

    def to_records(
        self, *, workers: int | None = None, optimize: bool = True, device=None
    ) -> list[dict]:
        return self.execute(workers=workers, optimize=optimize, device=device)[0]

    def arrays(
        self, *, workers: int | None = None, optimize: bool = True, device=None
    ) -> dict[str, np.ndarray]:
        """Materialize tokenized model-input arrays whole-frame."""
        self._require_valid(streaming=False, optimize=optimize)
        frame, _ = self._materialize(
            self._resolve_workers(workers), optimize, exact=workers is not None,
            device=device,
        )
        return P.execute_array_nodes(frame, self._array_nodes())

    def iter_batches(
        self,
        *,
        workers: int | None = None,
        optimize: bool = True,
        epochs: int | None = 1,
        shuffle_buffer: int | None = None,
        executor: str | None = None,
        stats: dict | None = None,
        device=None,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Batch iterator of host arrays; streams per shard when
        ``.prefetch()`` is declared and the source has not already been
        materialized. ``device`` is where the ``device`` backend's scan
        passes run.

        Worker count resolves explicit ``workers`` > ``.workers(n)`` >
        ``REPRO_WORKERS`` > default (2 for streaming, 1 whole-frame);
        likewise ``executor`` falls back to ``.workers(executor=...)`` then
        ``REPRO_EXECUTOR``. ``stats`` (a dict) receives executor/cache
        counters after each streamed epoch.

        The plan is validated eagerly, at this call and not at the first
        ``next()``, so an invalid plan raises a diagnostic-bearing
        :class:`repro_torch.analysis.PlanValidationError` before any
        executor thread starts."""
        self._require_valid(optimize=optimize)
        batch = self._batch_node()
        if self._streaming():
            EngineConfig(executor=executor or self._options.get("executor")).resolve_executor()
            return P.stream_batches(
                self._nodes,
                workers=self._resolve_workers(workers, default=2),
                optimize=optimize,
                epochs=epochs,
                shuffle_buffer=shuffle_buffer,
                final_schema=self._needed_columns(),
                executor=executor or self._options.get("executor"),
                cache_dir=self._resolve_cache_dir(),
                stats=stats,
                remote=self._options.get("remote"),
                backend=self._resolve_backend(),
                device=self._scan_device(device),
            )
        return self._whole_frame_batches(batch, workers, optimize, epochs, device)

    def _whole_frame_batches(
        self,
        batch: P.Batch,
        workers: int | None,
        optimize: bool,
        epochs: int | None,
        device=None,
    ) -> Iterator[dict[str, np.ndarray]]:
        arrays = self.arrays(workers=workers, optimize=optimize, device=device)
        epoch = 0
        while epochs is None or epoch < epochs:
            produced = 0
            for b in _array_batches(
                arrays,
                batch.batch_size,
                shuffle=batch.shuffle,
                seed=batch.seed + epoch,
                drop_remainder=batch.drop_remainder,
                pad_to=batch.pad_to,
                bucket_by=batch.bucket_by,
                buckets=batch.buckets,
            ):
                produced += 1
                yield b
            if not produced:
                return  # empty epoch: stop instead of spinning forever
            epoch += 1

    def device_batches(
        self,
        *,
        workers: int | None = None,
        optimize: bool = True,
        epochs: int | None = 1,
        prefetch: int | None = None,
        sharding: Any = None,
        executor: str | None = None,
        overlap: bool = False,
        profiler: Any = None,
        device=None,
        stats: dict | None = None,
    ):
        """Terminal: batches prefetched onto ``device`` (the card unless the
        chain or the caller names another) through
        :class:`~repro_torch.core.async_loader.AsyncLoader`, so host
        preprocessing overlaps device compute. With ``overlap=True`` (or an
        explicit ``profiler``) returns a
        :class:`~repro_torch.core.device_pipeline.DeviceFeed` instead:
        batches snap onto the plan's fixed bucket grid, copies run one
        batch ahead, and the feed's profiler accounts device-idle time per
        step. ``sharding`` is refused. ``stats`` (a dict) receives the
        executor and cache counters, as ``iter_batches``'s does."""
        from .async_loader import refuse_sharding

        self._require_valid(optimize=optimize)
        node = next((n for n in self._nodes if isinstance(n, P.Prefetch)), None)
        depth = prefetch if prefetch is not None else (node.prefetch if node else 2)
        shard = sharding if sharding is not None else (node.sharding if node else None)
        refuse_sharding(shard)
        target = resolve(self._resolve_device(device))
        it = self.iter_batches(
            workers=workers, optimize=optimize, epochs=epochs, executor=executor,
            stats=stats, device=device,
        )
        if overlap or profiler is not None:
            from .device_pipeline import DeviceFeed

            return DeviceFeed(
                it,
                grid=self.bucket_grid_spec(),
                prefetch=depth,
                profiler=profiler,
                device=target,
            )
        return AsyncLoader(it, prefetch=depth, device=target)

    def row_program(self, *, optimize: bool = True, device=None):
        """Terminal: lower this plan to a per-request
        :class:`~repro_torch.runtime.row_program.RowProgram` for online
        serving.

        The *same* optimized step chain the shard executors run — compiled
        by the same :func:`repro_torch.core.executor.compile_shard_program`
        from the same plan, carrying the same frozen token specs and
        vocabulary fingerprint — packaged for single-row execution with no
        shard/pool/shared-memory machinery, so a served request is
        byte-identical to the training path by construction. ``device`` is
        where the ``device`` backend's scan passes run: the terminal's,
        else the chain's ``.device(...)``, else the card.

        Requires a tokenized ``SourceJsonDirs`` chain whose steps are all
        row-local; cross-row plans (``drop_duplicates``, ``split``) raise
        a :class:`repro_torch.analysis.PlanValidationError` carrying
        ``P016`` diagnostics. Copy of ``repro/core/dataset.py:883``.
        """
        import dataclasses

        from ..analysis import PlanValidationError, check_row_program_plan
        from ..runtime.row_program import RowProgram
        from . import executor as EX

        self._require_valid(streaming=False, optimize=optimize)
        errors = [
            d for d in check_row_program_plan(self._nodes) if d.severity == "error"
        ]
        if errors:
            raise PlanValidationError(errors)
        tok = next(n for n in self._nodes if isinstance(n, P.Tokenize))
        frame_nodes, _ = P.split_plan(self._nodes)
        if optimize:
            frame_nodes = P.optimize_plan(frame_nodes, self._needed_columns())
        spec_cols = tuple(dict.fromkeys(spec.column for spec in tok.specs))
        token_plan = EX.TokenPlan(
            specs=tuple(tok.specs),
            stoi=dict(tok.tokenizer.stoi),
            vocab_fp=tok.tokenizer.fingerprint,
        )
        program = EX.compile_shard_program(
            frame_nodes,
            optimize=optimize,
            output_columns=spec_cols,
            tokens=token_plan,
            backend=self._resolve_backend(),
            device=self._scan_device(device),
        )
        return RowProgram(
            fields=program.fields,
            steps=program.steps,
            specs=program.tokens.specs,
            stoi=program.tokens.stoi,
            vocab_fp=program.tokens.vocab_fp,
            backend=program.backend,
            # where the scans run is no part of what the plan computes
            fingerprint=EX.program_fingerprint(dataclasses.replace(program, device=None)),
            device=program.device,
        )
