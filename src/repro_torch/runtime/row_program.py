"""Per-request lowering of a compiled shard program: zero train/serve skew.

Copy of ``repro/runtime/row_program.py``. A :class:`RowProgram` is the
serving-side twin of :class:`repro_torch.core.executor.ShardProgram`: the
same optimized step chain (select / dropna / filter / compiled column
expressions) followed by the same frozen token plan (specs + vocabulary,
pinned by the vocab fingerprint), with every shard-sized assumption
removed: no shard pool, no shared memory, no worker processes, no cache.
Input is a raw string (or a field dict), output is the int32 token arrays
the training executors would have produced for that row, byte-identical
by construction: both paths are compiled by ``compile_shard_program`` from
the same plan, and the evaluator here mirrors ``execute_program``'s
flat-buffer semantics op for op (``tests/test_torch_row_program.py`` holds
it row by row against the shard executor under every backend).

Built via :meth:`repro_torch.core.dataset.Dataset.row_program`: the
analyzer first proves the plan row-executable (diagnostic ``P016``:
cross-row steps like ``drop_duplicates`` or whole-frame ``split`` cannot
run per request).

Where the port differs. :class:`RowProgram` carries the ``device`` on which
the ``device`` backend's scan passes run (the card unless the plan's
terminal names another), as the shard program does; it is left out of the
fingerprint, as the shard program's lineage fingerprints leave it out.

Contract (the reference's linter rule R005): this module and
:mod:`repro_torch.runtime.serve_loop` form the serve hot path and never
import the shard/shm/pool machinery (``core.executor``,
``core.async_loader``, ``multiprocessing``). Only the pure compute layers
are allowed: :mod:`repro_torch.core.bytesops`, :mod:`repro_torch.core.expr`
and the encoders in :mod:`repro_torch.data.batching`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from ..core import bytesops as B
from ..core import expr as E
from ..data.batching import TokenSpec, VocabTable, encode_flat, encode_rows

# Step kinds a single row can execute: everything row-local. Cross-row
# steps (dedup and its two-pass split) hold state over the whole corpus
# and are rejected at construction (and earlier, by analyzer code P016).
ROW_EXECUTABLE_STEPS = ("select", "dropna", "filter", "project")


class RowProgramError(ValueError):
    """The program cannot be lowered to per-row execution. Copy of
    ``repro/runtime/row_program.py:47``."""


def _flatten_raw(values: Sequence[Any]) -> np.ndarray:
    """Flatten raw column values exactly like ``ColumnarFrame.flat``:
    None -> "", str() conversion, NUL bytes (the row separator) -> space.
    Copy of ``repro/runtime/row_program.py:51``."""
    rows = ["" if v is None else str(v).replace("\x00", " ") for v in values]
    return B.flatten(rows)


def _flat_take(buf: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Copy of ``repro/runtime/row_program.py:58``."""
    # Mirror of executor._flat_take (kept local: R005 bans that import).
    if buf.size == 0 or keep.all():
        return buf
    return buf[np.repeat(keep, B.row_lengths(buf))]


@dataclass(frozen=True)
class RowProgram:
    """A precompiled request-to-tokens program.

    ``fields``/``steps``/``backend`` are lifted verbatim from the compiled
    :class:`ShardProgram`; ``specs``/``stoi``/``vocab_fp`` are its frozen
    :class:`TokenPlan`. ``fingerprint`` is the shard program's structural
    fingerprint — cache keys derived from it (e.g. the serve-loop ring
    cache) are therefore shared with nothing but this exact plan + vocab.
    ``device`` is where the ``device`` backend's scan passes run; like the
    shard program's, it is no part of the fingerprint. Copy of
    ``repro/runtime/row_program.py:66``.
    """

    fields: tuple[str, ...]
    steps: tuple[tuple[str, Any], ...]
    specs: tuple[TokenSpec, ...]
    stoi: Mapping[str, int]
    vocab_fp: str
    backend: str = "device"
    fingerprint: str = ""
    device: str | None = None
    _table: list = field(default_factory=list, repr=False, compare=False)

    def __post_init__(self):
        for kind, _ in self.steps:
            if kind not in ROW_EXECUTABLE_STEPS:
                raise RowProgramError(
                    f"step {kind!r} holds cross-row state; not row-executable"
                )
        if not self.specs:
            raise RowProgramError("row programs require a token plan (tokenize())")

    @property
    def output_names(self) -> tuple[str, ...]:
        return tuple(spec.name for spec in self.specs)

    @property
    def table(self) -> VocabTable:
        if not self._table:  # lazy: built once, ~O(vocab) to sort
            self._table.append(VocabTable(dict(self.stoi)))
        return self._table[0]

    # -- input normalization ----------------------------------------------
    @staticmethod
    def _normalize(value: Any) -> Any:
        # Ingest-time invariant (mirror of ingest._normalize, kept local
        # per R005): NUL is the flat-buffer row separator and never
        # survives into the engine, so a served request's text must be
        # sanitized exactly like a parsed shard record.
        if isinstance(value, str) and "\x00" in value:
            return value.replace("\x00", " ")
        return value

    def _columns(self, rows: Sequence[Any]) -> dict[str, list]:
        """Column-major raw values for ``rows`` of strings (single-field
        programs) or field dicts (missing fields -> None, like a JSON
        record that lacks the key)."""
        cols: dict[str, list] = {f: [] for f in self.fields}
        for row in rows:
            if isinstance(row, str) or row is None:
                if len(self.fields) != 1:
                    raise RowProgramError(
                        f"program reads fields {self.fields}; pass a dict, "
                        "not a bare string"
                    )
                cols[self.fields[0]].append(self._normalize(row))
            elif isinstance(row, Mapping):
                for f in self.fields:
                    cols[f].append(self._normalize(row.get(f)))
            else:
                raise RowProgramError(f"unsupported request row {type(row).__name__}")
        return cols

    # -- evaluation --------------------------------------------------------
    def encode_batch(
        self, rows: Sequence[Any]
    ) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Run the program over a micro-batch of raw request rows.

        Returns ``(outputs, keep)``: one ``(n_kept, max_len)`` int32 array
        per token spec, and a boolean mask over the *input* rows marking
        which survived the plan's filters (a served request whose row is
        filtered out gets an empty response, it does not shift its
        neighbors' outputs).

        The evaluator mirrors ``execute_program``: projected columns live
        as flat byte buffers (``flat``), raw source columns flatten lazily
        and memoize (``src_flat``), and row-dropping steps compact both via
        the same repeat-by-row-length take.
        """
        live = self._columns(rows)
        n = len(rows)
        orig = np.arange(n)
        flat: dict[str, np.ndarray] = {}
        src_flat: dict[str, np.ndarray] = {}

        def lookup(c: str) -> np.ndarray:
            if c in flat:
                return flat[c]
            if c not in src_flat:
                src_flat[c] = _flatten_raw(live[c])
            return src_flat[c]

        def take_rows(keep: np.ndarray) -> None:
            nonlocal orig
            if keep.all():
                return
            for d in (flat, src_flat):
                for c in d:
                    d[c] = _flat_take(d[c], keep)
            for c in live:
                live[c] = [v for v, k in zip(live[c], keep) if k]
            orig = orig[keep]

        for kind, arg in self.steps:
            if kind == "select":
                for d in (flat, src_flat, live):
                    for c in [c for c in d if c not in arg]:
                        del d[c]
            elif kind == "dropna":
                cur = len(orig)
                keep = np.ones(cur, dtype=bool)
                for c in arg:
                    if c in flat:
                        keep &= B.row_nonempty(flat[c])
                    else:
                        keep &= np.fromiter(
                            (v is not None and v != "" for v in live[c]),
                            dtype=bool,
                            count=cur,
                        )
                take_rows(keep)
            elif kind == "filter":
                take_rows(E.eval_mask(arg, lookup, len(orig), self.backend, self.device))
            else:  # project
                cur = len(orig)
                for out_col, comp in arg:
                    if comp[0] == "chain" and not comp[2]:  # pure alias
                        flat[out_col] = lookup(comp[1])
                    else:
                        flat[out_col] = E.eval_str(comp, lookup, cur, self.backend,
                                                   self.device)

        outputs: dict[str, np.ndarray] = {}
        for spec in self.specs:
            col = spec.column
            if col in flat:
                outputs[spec.name] = encode_flat(
                    flat[col], self.table, spec.max_len, spec.add_start_end
                )
            else:
                outputs[spec.name] = encode_rows(
                    list(live[col]),
                    self.stoi,
                    spec.max_len,
                    spec.add_start_end,
                    table=self.table,
                )
        keep_mask = np.zeros(n, dtype=bool)
        keep_mask[orig] = True
        return outputs, keep_mask

    def __call__(self, row: Any) -> dict[str, np.ndarray] | None:
        """Encode one request row; ``None`` when the plan filters it out."""
        outputs, keep = self.encode_batch([row])
        if not keep[0]:
            return None
        return outputs
