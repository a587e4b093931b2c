"""The port's contract linter: its load-bearing invariants as AST rules.

Copy of ``repro/analysis/contracts.py``: ``ALL_RULES`` (``:48``),
``build_import_graph`` (``:104``) and ``lint_contracts`` (``:370``), with
the same codes, severities, message forms and :class:`Diagnostic` shape,
run as the port's own contracts over ``src/repro_torch``:

* ``R001`` — the remote worker tier imports no accelerator stack: nothing
  module-level reachable from ``<pkg>.distributed.worker`` or
  ``<pkg>.distributed.transport`` imports ``torch``, ``triton``, ``jax``
  or ``repro`` (the JAX package) at module level. A worker under a host
  backend never imports torch; under ``device`` it imports it lazily,
  before the first shard whose steps it runs.
* ``R002`` — the same for the spawn-side byte paths ``<pkg>.core.bytesops``
  / ``core.executor`` / ``core.pipeline``: the process shard executor and
  the stage pipeline spawn workers that import them, and under a host
  backend those never import torch.
* ``R003`` — cache and heartbeat file writes are atomic: any function in
  ``core/executor.py``, ``runtime/fault_tolerance.py`` (``Heartbeat``),
  ``distributed/coordinator.py`` or ``distributed/worker.py`` that writes
  a file stages it through a temp file and ``os.replace`` (a monitor must
  never read a torn write).
* ``R004`` — no bare ``except:`` in ``core/executor.py``, ``runtime/`` or
  ``distributed/`` (it swallows ``KeyboardInterrupt``/``SystemExit`` and
  turns worker shutdown into a hang).
* ``R005`` — the serve hot path (``runtime.serve_loop`` /
  ``runtime.row_program``) never imports the shard/shm/pool machinery:
  ``core.executor``, ``core.async_loader``, ``<pkg>.distributed`` or
  ``multiprocessing``. Package ``__init__`` re-export hubs are left out of
  the traversal, as in the reference.

Where the port differs: R001 and R002 ban ``torch``, ``triton``, ``jax``
and ``repro`` (the reference bans ``jax``); a module that imports two of
them gets one diagnostic for each. Standard library only (``ast`` and
``pathlib``): ``python -m repro_torch.analysis --contracts src/repro_torch``
needs neither numpy nor torch. Function-level (lazy) imports are exempt
from R001/R002 by construction: only module-level statements (including
those under top-level ``if``/``try``/``with``) run at import time.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Sequence

from .diagnostics import Diagnostic

ALL_RULES = ("R001", "R002", "R003", "R004", "R005")

# Module suffixes (relative to the package) whose import closure must be
# free of the banned stacks, per rule.
_WORKER_TIER_ROOTS = ("distributed.worker", "distributed.transport")
_SPAWN_SIDE_ROOTS = ("core.bytesops", "core.executor", "core.pipeline")
# Top-level imports R001/R002 ban from those closures, in report order.
_BANNED_STACKS = ("torch", "triton", "jax", "repro")

# The serve hot path (R005) and the shard/shm/pool machinery it must
# never reach. Internal names are package-relative prefixes; external
# names are top-level import bases.
_SERVE_HOT_ROOTS = ("runtime.serve_loop", "runtime.row_program")
_SERVE_BANNED_INTERNAL = ("core.executor", "core.async_loader", "distributed")
_SERVE_BANNED_EXTERNAL = ("multiprocessing",)

# Files whose writes must be atomic (cache + heartbeat surfaces), relative
# to the package root.
_ATOMIC_WRITE_SCOPE = (
    "core/executor.py",
    "runtime/fault_tolerance.py",
    "distributed/coordinator.py",
    "distributed/worker.py",
)

# Path prefixes (relative to the package root) where bare except is banned.
_BARE_EXCEPT_SCOPE = ("core/executor.py", "runtime/", "distributed/")


@dataclass
class ModuleInfo:
    """One module's import surface, module-level statements only."""

    name: str
    path: Path
    internal: list[tuple[str, int]] = field(default_factory=list)
    external: dict[str, int] = field(default_factory=dict)  # base -> lineno


def _module_level_stmts(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements that execute at import time: the module body plus the
    bodies of top-level ``if``/``try``/``with`` — but never function or
    class bodies (those are the sanctioned lazy-import escape hatch)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, ast.If):
            yield from _module_level_stmts(stmt.body)
            yield from _module_level_stmts(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            yield from _module_level_stmts(stmt.body)
            yield from _module_level_stmts(stmt.orelse)
            yield from _module_level_stmts(stmt.finalbody)
            for handler in stmt.handlers:
                yield from _module_level_stmts(handler.body)
        elif isinstance(stmt, ast.With):
            yield from _module_level_stmts(stmt.body)


def build_import_graph(root: Path) -> dict[str, ModuleInfo]:
    """Parse every ``.py`` under the package dir ``root`` (its basename is
    the package name) into a module-level import graph. Namespace
    subpackages (no ``__init__.py``) are handled: they contribute no
    import-time code, so they simply have no node."""
    root = Path(root).resolve()
    pkg = root.name
    modules: dict[str, ModuleInfo] = {}
    for py in sorted(root.rglob("*.py")):
        rel_parts = py.relative_to(root).with_suffix("").parts
        if rel_parts[-1] == "__init__":
            rel_parts = rel_parts[:-1]
        name = ".".join((pkg,) + rel_parts)
        modules[name] = ModuleInfo(name, py)

    def record(mod: ModuleInfo, dotted: str, lineno: int) -> None:
        parts = dotted.split(".")
        if parts[0] != pkg:
            mod.external.setdefault(parts[0], lineno)
            return
        # The imported module itself (or the deepest known prefix of it)...
        for k in range(len(parts), 0, -1):
            cand = ".".join(parts[:k])
            if cand in modules:
                mod.internal.append((cand, lineno))
                break
        # ...plus every parent package with a real __init__.py: importing
        # a.b.c executes a/__init__.py and a/b/__init__.py too.
        for k in range(1, len(parts)):
            cand = ".".join(parts[:k])
            if cand in modules and modules[cand].path.name == "__init__.py":
                mod.internal.append((cand, lineno))

    for mod in modules.values():
        try:
            tree = ast.parse(mod.path.read_text(encoding="utf-8"))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
        is_package = mod.path.name == "__init__.py"
        for stmt in _module_level_stmts(tree.body):
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    record(mod, alias.name, stmt.lineno)
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level == 0:
                    base = stmt.module or ""
                else:
                    here = mod.name.split(".")
                    if not is_package:
                        here = here[:-1]
                    here = here[: len(here) - (stmt.level - 1)]
                    base = ".".join(
                        here + (stmt.module.split(".") if stmt.module else [])
                    )
                if not base:
                    continue
                record(mod, base, stmt.lineno)
                for alias in stmt.names:
                    cand = base + "." + alias.name
                    if cand.startswith(pkg + ".") and cand in modules:
                        record(mod, cand, stmt.lineno)
    return modules


def _reachable(
    modules: dict[str, ModuleInfo], roots: Sequence[str]
) -> tuple[set[str], dict[str, str]]:
    """Modules import-reachable from ``roots`` + BFS parent pointers."""
    parent: dict[str, str] = {}
    seen = {r for r in roots if r in modules}
    queue = list(seen)
    while queue:
        cur = queue.pop(0)
        for dep, _ in modules[cur].internal:
            if dep not in seen:
                seen.add(dep)
                parent[dep] = cur
                queue.append(dep)
    return seen, parent


def _check_stack_free(
    modules: dict[str, ModuleInfo],
    roots: Sequence[str],
    code: str,
    contract: str,
) -> list[Diagnostic]:
    seen, parent = _reachable(modules, roots)
    diags: list[Diagnostic] = []
    for name in sorted(seen):
        mod = modules[name]
        chain = [name]
        while chain[-1] in parent:
            chain.append(parent[chain[-1]])
        for base in _BANNED_STACKS:
            if base not in mod.external:
                continue
            diags.append(
                Diagnostic(
                    code,
                    f"{base} is module-level reachable from {contract}: "
                    + " -> ".join(reversed(chain)),
                    provenance=(f"{mod.path}:{mod.external[base]}: import {base}",),
                )
            )
    return diags


def _is_write_call(node: ast.Call) -> bool:
    """``open(..., 'w'|'a'|'x'...)``, ``.open('w'...)``, ``.write_text`` /
    ``.write_bytes`` — the file-creating writes the atomicity rule covers."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in (
        "write_text",
        "write_bytes",
    ):
        return True
    is_open = (isinstance(func, ast.Name) and func.id == "open") or (
        isinstance(func, ast.Attribute) and func.attr == "open"
    )
    if not is_open:
        return False
    mode = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = node.args[1].value
    elif len(node.args) == 1 and isinstance(func, ast.Attribute):
        if isinstance(node.args[0], ast.Constant):
            mode = node.args[0].value  # Path.open("w")
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in "wax")


def _is_atomic_marker(node: ast.Call) -> bool:
    """``os.replace``/``os.rename``, ``mkstemp``, ``NamedTemporaryFile`` —
    evidence the enclosing function stages writes through a temp file."""
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else ""
    )
    return name in ("replace", "rename", "mkstemp", "NamedTemporaryFile")


def _check_atomic_writes(root: Path) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    for rel in _ATOMIC_WRITE_SCOPE:
        path = root / rel
        if not path.exists():
            continue
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except (SyntaxError, OSError):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            writes: list[int] = []
            atomic = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    if _is_write_call(node):
                        writes.append(node.lineno)
                    if _is_atomic_marker(node):
                        atomic = True
            if writes and not atomic:
                diags.append(
                    Diagnostic(
                        "R003",
                        f"{fn.name}() writes a file without temp+os.replace "
                        "staging; a reader can observe a torn write",
                        provenance=tuple(f"{path}:{ln}" for ln in writes),
                    )
                )
    return diags


def _check_serve_hot_path(
    modules: dict[str, ModuleInfo], pkg: str
) -> list[Diagnostic]:
    """R005: walk the module-level import closure of the serve hot path —
    skipping package ``__init__`` nodes, whose re-export edges would pull
    in the whole package surface — and flag any import of the shard
    machinery (direct or transitive through a traversed module)."""
    roots = [f"{pkg}.{m}" for m in _SERVE_HOT_ROOTS]
    banned = tuple(f"{pkg}.{m}" for m in _SERVE_BANNED_INTERNAL)

    def is_init(name: str) -> bool:
        mod = modules.get(name)
        return mod is not None and mod.path.name == "__init__.py"

    parent: dict[str, str] = {}
    seen = {r for r in roots if r in modules}
    queue = list(seen)
    while queue:
        cur = queue.pop(0)
        for dep, _ in modules[cur].internal:
            if dep not in seen and not is_init(dep):
                seen.add(dep)
                parent[dep] = cur
                queue.append(dep)

    diags: list[Diagnostic] = []
    flagged: set[tuple[str, str]] = set()
    for name in sorted(seen):
        mod = modules[name]
        chain = [name]
        while chain[-1] in parent:
            chain.append(parent[chain[-1]])
        via = " -> ".join(reversed(chain))
        for dep, lineno in mod.internal:
            if not any(dep == b or dep.startswith(b + ".") for b in banned):
                continue
            if (name, dep) in flagged:
                continue
            flagged.add((name, dep))
            diags.append(
                Diagnostic(
                    "R005",
                    f"serve hot path imports shard machinery {dep} "
                    f"(via {via}); per-request serving must stay free of "
                    "pool/shm/coordinator code",
                    provenance=(f"{mod.path}:{lineno}",),
                )
            )
        for base in _SERVE_BANNED_EXTERNAL:
            if base in mod.external and (name, base) not in flagged:
                flagged.add((name, base))
                diags.append(
                    Diagnostic(
                        "R005",
                        f"serve hot path imports {base} (via {via}); "
                        "per-request serving must stay single-process",
                        provenance=(f"{mod.path}:{mod.external[base]}",),
                    )
                )
    return diags


def _check_bare_except(root: Path) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    files: list[Path] = []
    for prefix in _BARE_EXCEPT_SCOPE:
        target = root / prefix
        if target.is_dir():
            files += sorted(target.rglob("*.py"))
        elif target.exists():
            files.append(target)
    for path in files:
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except (SyntaxError, OSError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                diags.append(
                    Diagnostic(
                        "R004",
                        "bare `except:` in executor/runtime code swallows "
                        "KeyboardInterrupt/SystemExit; catch Exception (or "
                        "narrower)",
                        provenance=(f"{path}:{node.lineno}",),
                    )
                )
    return diags


def lint_contracts(
    root: str | Path, rules: Sequence[str] | None = None
) -> list[Diagnostic]:
    """Run the contract rules over a package directory (e.g.
    ``src/repro_torch``). ``rules`` selects a subset (default: all)."""
    root = Path(root).resolve()
    pkg = root.name
    active = tuple(rules) if rules else ALL_RULES
    diags: list[Diagnostic] = []
    if "R001" in active or "R002" in active or "R005" in active:
        modules = build_import_graph(root)
        if "R001" in active:
            diags += _check_stack_free(
                modules,
                [f"{pkg}.{m}" for m in _WORKER_TIER_ROOTS],
                "R001",
                "the torch-free worker tier (distributed.worker/transport)",
            )
        if "R002" in active:
            diags += _check_stack_free(
                modules,
                [f"{pkg}.{m}" for m in _SPAWN_SIDE_ROOTS],
                "R002",
                "a spawn-side bytes path (core.bytesops/executor/pipeline)",
            )
        if "R005" in active:
            diags += _check_serve_hot_path(modules, pkg)
    if "R003" in active:
        diags += _check_atomic_writes(root)
    if "R004" in active:
        diags += _check_bare_except(root)
    return diags
