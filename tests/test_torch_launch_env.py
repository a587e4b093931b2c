"""The port's tuned launch environment (``repro_torch.launch.env``): the
counterparts of the seven tests of ``tests/test_launch_env.py`` that do
not concern XLA flags, the refusal of a host device count (the three
XLA-flag tests wait for the port's mesh, ROADMAP.md Queue 1 item 6.4),
the reference's values for the variables both set, and the CLI's exports
and exec."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import env as ref_env
from repro_torch.launch import env as launch_env

ROOT = Path(__file__).resolve().parents[1]


def test_tuned_env_baseline_has_no_framework_flags():
    e = launch_env.tuned_env(tcmalloc=False)
    assert e == {}  # no TensorFlow to silence, fp32 is torch's default, no mesh pin


def test_tcmalloc_preload_when_present(tmp_path, monkeypatch):
    lib = tmp_path / "libtcmalloc.so.4"
    lib.write_bytes(b"")
    monkeypatch.setattr(launch_env, "TCMALLOC_CANDIDATES", (str(tmp_path / "missing"), str(lib)))
    e = launch_env.tuned_env()
    assert e["LD_PRELOAD"] == str(lib)
    assert e["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == launch_env.TCMALLOC_REPORT_THRESHOLD


def test_tcmalloc_absent_no_preload(monkeypatch):
    monkeypatch.setattr(launch_env, "TCMALLOC_CANDIDATES", ("/nonexistent/lib.so",))
    e = launch_env.tuned_env()
    assert "LD_PRELOAD" not in e
    assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in e


def test_the_shared_variables_are_the_references():
    want = ref_env.tuned_env(base={})
    got = launch_env.tuned_env()
    assert got == {k: v for k, v in want.items()
                   if k in ("LD_PRELOAD", "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")}
    assert launch_env.TCMALLOC_CANDIDATES == ref_env.TCMALLOC_CANDIDATES
    assert launch_env.find_tcmalloc() == ref_env.find_tcmalloc()


def test_apply_respects_user_values(monkeypatch):
    monkeypatch.setenv("LD_PRELOAD", "/user/lib.so")
    # set, then deleted: monkeypatch restores the variable whatever apply sets
    monkeypatch.setenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "0")
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")
    applied = launch_env.apply({"LD_PRELOAD": "/tuned/lib.so",
                                "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1"})
    assert "LD_PRELOAD" not in applied  # user export wins
    assert os.environ["LD_PRELOAD"] == "/user/lib.so"
    assert applied["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "1"
    assert os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "1"


def test_apply_overwrite(monkeypatch):
    monkeypatch.setenv("LD_PRELOAD", "/user/lib.so")
    applied = launch_env.apply({"LD_PRELOAD": "/tuned/lib.so"}, overwrite=True)
    assert applied == {"LD_PRELOAD": "/tuned/lib.so"}
    assert os.environ["LD_PRELOAD"] == "/tuned/lib.so"


def test_render_exports_quoted_and_sorted():
    out = launch_env.render_exports({"B_FLAG": "a b", "A_FLAG": "plain"})
    assert out.splitlines() == ["export A_FLAG=plain", "export B_FLAG='a b'"]
    assert out == ref_env.render_exports({"B_FLAG": "a b", "A_FLAG": "plain"})


def test_main_prints_exports(capsys, tmp_path, monkeypatch):
    lib = tmp_path / "lib tcmalloc.so.4"
    lib.write_bytes(b"")
    monkeypatch.setattr(launch_env, "TCMALLOC_CANDIDATES", (str(lib),))
    assert launch_env.main([]) == 0
    out = capsys.readouterr().out
    assert f"export LD_PRELOAD='{lib}'" in out
    assert "export TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000" in out
    assert "TF_CPP_MIN_LOG_LEVEL" not in out and "XLA_FLAGS" not in out


def test_a_host_device_count_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6.4"):
        launch_env.tuned_env(8)
    with pytest.raises(SystemExit, match="Queue 1 item 6.4"):
        launch_env.main(["--devices", "16"])


def run_cli(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.env", *args], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=60)


def test_the_cli_exports_and_execs():
    proc = run_cli("--no-tcmalloc")
    assert proc.returncode == 0 and proc.stdout == "\n"
    code = "import os, sys; print(os.environ.get('TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD'))"
    proc = run_cli("--", sys.executable, "-c", code)
    assert proc.returncode == 0, proc.stderr
    lib = launch_env.find_tcmalloc()
    assert proc.stdout.strip() == (launch_env.TCMALLOC_REPORT_THRESHOLD if lib else "None")
    assert run_cli("--devices", "2").returncode != 0
