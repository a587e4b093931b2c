"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing builds nothing,
and no entry point picks the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPT = ROOT / "chip_smoke.py"


def port_modules() -> list[str]:
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_importing_the_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules()!r}: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None, 'importing built or loaded the kernels'\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_planner_modules_are_covered():
    """The scans above reach every module of the ``Dataset`` planner."""
    names = set(port_modules())
    for name in ("core.dataset", "core.plan", "core.executor", "core.expr", "core.bytesops",
                 "core.engine_config", "core.ingest", "data.batching", "analysis",
                 "analysis.diagnostics", "analysis.expr_check", "analysis.plan_analyzer",
                 "analysis.rewrites"):
        assert f"repro_torch.{name}" in names


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [SCRIPT]
    assert len(files) > 10
    for path in files:
        bad = imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_never_picks_the_cpu():
    from repro_torch.device import default_device, resolve

    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            default_device()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve(None)
    assert resolve("cpu") == torch.device("cpu")


def test_cpu_tensor_leaves_the_launch_counters_at_zero():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.text_clean import ops as scan_ops

    counters = [(lstm_ops, "lstm_cell"), (scan_ops, "text_scan"), (scan_ops, "text_clean"),
                (flash_ops, "flash_attention"), (rg_ops, "rg_lru"), (mlstm_ops, "mlstm_chunk")]
    before = [mod.LAUNCHES[name] for mod, name in counters]
    x, h = torch.ones(2, 3), torch.zeros(2, 4)
    lstm_ops.lstm_cell_op(x, h, h, torch.ones(3, 16), torch.ones(4, 16), torch.zeros(16))
    buf = np.frombuffer(b"A <b>x</b>\x00", dtype=np.uint8)
    assert scan_ops.scan_flat(buf, strip_html=True, device="cpu").tobytes() == b"a x\x00"
    assert scan_ops.clean_rows(["A <b>x</b>"], device="cpu") == ["a x"]
    scan_ops.text_clean_op(torch.zeros(2, 3, dtype=torch.uint8))
    q = torch.ones(1, 3, 2, 8)
    flash_ops.flash_attention_op(q, q, q)
    rg_ops.rg_lru_op(torch.ones(1, 3, 4), torch.ones(1, 3, 4), torch.zeros(1, 4))
    mlstm_ops.mlstm_chunk_op(q, q, q, torch.zeros(1, 3, 2), torch.zeros(1, 3, 2),
                             torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8),
                             torch.full((1, 2), -1e30))
    assert [mod.LAUNCHES[name] for mod, name in counters] == before


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """Alone in a directory, or without CUDA, the script exits non-zero and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(SCRIPT.read_bytes())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, SCRIPT))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
