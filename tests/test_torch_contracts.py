"""The port's contract linter against the JAX package's.

On source trees planted in ``tmp_path`` (as ``tests/test_plan_diagnostics.py``
plants them), with a ``jax`` violation of each rule, both packages'
``lint_contracts`` give the same ``(code, path, line)`` diagnostics and
severities. The port's own cases: a module-level ``torch``, ``triton`` or
``repro`` import in the worker tier or a spawn-side byte path is flagged
(R001/R002) and a lazy one is not; the port's tree is clean, and a copy
whose ``runtime/fault_tolerance.py`` imports torch at module level breaks
R001 through the worker's ``Heartbeat`` import. The CLI exits 0 on the
port and 1 on a planted violation."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.contracts import lint_contracts as jax_lint
from repro_torch.analysis import contracts as PC
from repro_torch.analysis.contracts import lint_contracts

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def write(root: Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))


def plant_clean_tree(tmp_path: Path) -> Path:
    """The reference test's clean tree, with a serve loop and a row program."""
    write(tmp_path, "fakepkg/__init__.py", "")
    write(tmp_path, "fakepkg/distributed/__init__.py", "")
    write(tmp_path, "fakepkg/distributed/worker.py", "import os\n")
    write(tmp_path, "fakepkg/distributed/transport.py", "import socket\n")
    write(tmp_path, "fakepkg/core/__init__.py", "")
    write(tmp_path, "fakepkg/core/bytesops.py", "import re\n")
    write(tmp_path, "fakepkg/core/executor.py", "import os\n")
    write(tmp_path, "fakepkg/runtime/__init__.py", "")
    write(tmp_path, "fakepkg/runtime/serve_loop.py", "from fakepkg.runtime import row_program\n")
    write(tmp_path, "fakepkg/runtime/row_program.py", "import re\n")
    write(tmp_path, "fakepkg/runtime/fault_tolerance.py", """\
        import os
        import tempfile

        def beat(path):
            fd, tmp = tempfile.mkstemp(dir=".")
            with os.fdopen(fd, "w") as f:
                f.write("x")
            os.replace(tmp, path)
        """)
    return tmp_path / "fakepkg"


def keyed(diags) -> list[tuple[str, str, str, str]]:
    """``(code, severity, path, line)`` of each diagnostic's first provenance
    line (``path:line`` or ``path:line: import x``)."""
    out = []
    for d in diags:
        path, line = d.provenance[0].split(":")[:2]
        out.append((d.code, d.severity, path, line))
    return out


# One planted violation of each rule, written with jax where the rule
# bans an import: {relative path: source}.
JAX_VIOLATIONS = {
    "R001_transitive": {"fakepkg/util.py": "import jax\n",
                        "fakepkg/distributed/worker.py": "from fakepkg import util\n"},
    "R001_transport_in_try": {"fakepkg/distributed/transport.py": """\
        try:
            import jax.numpy as jnp
        except ImportError:
            jnp = None
        """},
    "R002_bytesops": {"fakepkg/core/bytesops.py": "import jax\n"},
    "R002_executor_via_package": {"fakepkg/core/__init__.py": "from jax import numpy\n",
                                  "fakepkg/core/executor.py":
                                  "from fakepkg.core import bytesops\n"},
    "R003_torn_write": {"fakepkg/runtime/fault_tolerance.py": """\
        def beat(path):
            with open(path, "w") as f:
                f.write("x")
        """},
    "R003_write_text": {"fakepkg/distributed/worker.py": """\
        from pathlib import Path

        def beat(path):
            Path(path).write_text("x")
        """},
    "R004_bare_except": {"fakepkg/distributed/worker.py": """\
        def run():
            try:
                pass
            except:
                pass
        """},
    "R004_runtime": {"fakepkg/runtime/row_program.py": """\
        try:
            import re
        except:
            re = None
        """},
    "R005_executor": {"fakepkg/runtime/row_program.py": "from fakepkg.core import executor\n"},
    "R005_multiprocessing": {"fakepkg/runtime/serve_loop.py": "import multiprocessing\n"},
    "R005_distributed": {"fakepkg/runtime/serve_loop.py":
                         "from fakepkg.distributed import worker\n"},
    "lazy_jax_is_exempt": {"fakepkg/distributed/worker.py": """\
        def lazy():
            import jax
            return jax
        """},
}


def test_both_linters_pass_the_clean_tree(tmp_path):
    pkg = plant_clean_tree(tmp_path)
    assert lint_contracts(pkg) == [] == jax_lint(pkg)


@pytest.mark.parametrize("case", sorted(JAX_VIOLATIONS))
def test_a_planted_violation_gives_the_references_diagnostics(tmp_path, case):
    pkg = plant_clean_tree(tmp_path)
    for rel, text in JAX_VIOLATIONS[case].items():
        write(tmp_path, rel, text)
    got, want = keyed(lint_contracts(pkg)), keyed(jax_lint(pkg))
    assert got == want
    code = case.split("_")[0]
    if code.startswith("R"):
        assert got and {c for c, *_ in got} == {code}, got
        assert {s for _, s, *_ in got} == {"error"}
    else:
        assert got == []


def test_the_messages_name_the_chain_and_the_import(tmp_path):
    pkg = plant_clean_tree(tmp_path)
    for rel, text in JAX_VIOLATIONS["R001_transitive"].items():
        write(tmp_path, rel, text)
    (diag,) = lint_contracts(pkg)
    (ref,) = jax_lint(pkg)
    assert "fakepkg.distributed.worker -> fakepkg.util" in diag.message
    assert diag.message.startswith("jax is module-level reachable from")
    assert diag.provenance == ref.provenance
    assert diag.render().splitlines()[0] == f"R001 error: {diag.message}"


PORT_ONLY = [
    ("fakepkg/distributed/worker.py", "import torch\n", "R001", "torch"),
    ("fakepkg/distributed/transport.py", "import triton.language as tl\n", "R001", "triton"),
    ("fakepkg/distributed/worker.py", "from repro.core import executor\n", "R001", "repro"),
    ("fakepkg/core/bytesops.py", "import torch\n", "R002", "torch"),
    ("fakepkg/core/executor.py", "from torch import nn\n", "R002", "torch"),
]


@pytest.mark.parametrize("rel,text,code,base", PORT_ONLY)
def test_a_module_level_accelerator_import_is_flagged_and_a_lazy_one_is_not(
        tmp_path, rel, text, code, base):
    """The port bans torch, triton and the JAX package where the reference
    bans jax; the reference's linter passes such a tree."""
    pkg = plant_clean_tree(tmp_path)
    write(tmp_path, rel, text)
    diags = lint_contracts(pkg)
    assert [(d.code, d.provenance) for d in diags] == \
        [(code, (f"{pkg / rel[len('fakepkg/'):]}:1: import {base}",))]
    assert diags[0].message.startswith(f"{base} is module-level reachable from")
    assert jax_lint(pkg) == []
    write(tmp_path, rel, "def lazy():\n    " + text.replace("\n", "\n    ").rstrip() + "\n")
    assert lint_contracts(pkg) == []


def test_two_banned_stacks_in_one_module_give_one_diagnostic_each(tmp_path):
    pkg = plant_clean_tree(tmp_path)
    write(tmp_path, "fakepkg/distributed/worker.py", "import jax\nimport torch\n")
    diags = lint_contracts(pkg)
    assert [(d.code, d.provenance[0].rsplit(" ", 1)[1]) for d in diags] == \
        [("R001", "torch"), ("R001", "jax")]
    assert keyed(jax_lint(pkg)) == keyed(d for d in diags if "import jax" in d.provenance[0])


def test_the_port_keeps_its_contracts():
    diags = lint_contracts(PORT)
    assert diags == [], "\n".join(d.render() for d in diags)
    assert PC.ALL_RULES == ("R001", "R002", "R003", "R004", "R005")
    modules = PC.build_import_graph(PORT)
    for name in ("distributed.worker", "distributed.transport", "distributed.coordinator",
                 "runtime.fault_tolerance", "analysis.contracts"):
        assert f"repro_torch.{name}" in modules


def test_a_module_level_torch_import_in_the_heartbeats_module_breaks_r001(tmp_path):
    """A copy of the port whose ``runtime/fault_tolerance.py`` imports torch
    at module level: R001 names the worker's path to it, and only R001
    (the process executor's closure does not reach it)."""
    copy = tmp_path / "repro_torch"
    for src in PORT.rglob("*.py"):
        dst = copy / src.relative_to(PORT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
    ft = copy / "runtime" / "fault_tolerance.py"
    ft.write_text(ft.read_text().replace("import os\n", "import os\n\nimport torch\n", 1))
    diags = lint_contracts(copy)
    assert [d.code for d in diags] == ["R001"]
    assert ("repro_torch.distributed.worker -> repro_torch.runtime.fault_tolerance"
            in diags[0].message)


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, timeout=120)


def test_cli_exit_codes(tmp_path):
    port = run_cli("--contracts", str(PORT))
    assert port.returncode == 0, port.stdout + port.stderr
    assert port.stdout.splitlines()[-1].startswith("contracts: 0 error(s), 0 warning(s)")
    pkg = plant_clean_tree(tmp_path)
    write(tmp_path, "fakepkg/distributed/worker.py", "import torch\n")
    seeded = run_cli("--contracts", str(pkg))
    assert seeded.returncode == 1
    assert "R001" in seeded.stdout and "1 error(s)" in seeded.stdout
    subset = run_cli("--contracts", str(pkg), "--rules", "R003,R004")
    assert subset.returncode == 0, subset.stdout + subset.stderr
    nothing = run_cli()
    assert nothing.returncode == 2 and "nothing to do" in nothing.stderr
