"""The port's tuned launch environment (``repro_torch.launch.env``): the
counterparts of the ten tests of ``tests/test_launch_env.py`` (a host
device count is a world of local ranks here, ``WORLD_SIZE``; the flag
merge is the reference's string function), the reference's values for the
variables both set, and the CLI's exports, exec, and ``--devices N``
running N ranks."""

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


def test_tuned_env_baseline_flags():
    """``tests/test_launch_env.py:10``: no device pin unless asked for."""
    e = launch_env.tuned_env(tcmalloc=False)
    assert "WORLD_SIZE" not in e and "XLA_FLAGS" not in e and "LD_PRELOAD" not in e


def test_host_device_count_pins_the_world():
    """``tests/test_launch_env.py:18``: N host devices are N local ranks."""
    e = launch_env.tuned_env(8, tcmalloc=False)
    assert e == {"WORLD_SIZE": "8"}
    assert ref_env.tuned_env(8, tcmalloc=False, base={})["XLA_FLAGS"] == \
        "--xla_force_host_platform_device_count=8"
    with pytest.raises(ValueError, match="host_device_count"):
        launch_env.tuned_env(0, tcmalloc=False)


@pytest.mark.parametrize("existing, flags", [
    ("--xla_step_marker_location=1 --xla_force_host_platform_device_count=2",
     ("--xla_force_host_platform_device_count=48",)),
    ("", ("--a=1", "--b=2")),
    ("--a=1 --b=2 --c", ("--b=3",)),
])
def test_xla_flags_merge_preserves_and_overrides(existing, flags):
    """``tests/test_launch_env.py:25``: the reference's string function."""
    merged = launch_env.merge_xla_flags(existing, *flags)
    assert merged == ref_env.merge_xla_flags(existing, *flags)
    toks = merged.split()
    assert all(f in toks for f in flags)


def test_tuned_env_merges_existing_xla_flags():
    """``tests/test_launch_env.py:36``: the merge keeps other flags and the
    new pin wins; the port's pin is the world size, which ``apply`` leaves
    to a value the user exported."""
    assert launch_env.merge_xla_flags(
        "--xla_step_marker_location=1", "--xla_force_host_platform_device_count=4") == \
        "--xla_step_marker_location=1 --xla_force_host_platform_device_count=4"
    assert launch_env.tuned_env(4, tcmalloc=False)["WORLD_SIZE"] == "4"


def test_devices_runs_the_command_as_ranks():
    """``--devices 2 -- python -c ...`` runs two ranks of the command, each
    with its rank and the world size; without a command the exports give
    the world."""
    code = ("import os; print('rank', os.environ['RANK'], os.environ['WORLD_SIZE'], "
            "os.environ['LOCAL_RANK'])")
    proc = run_cli("--no-tcmalloc", "--devices", "2", "--", sys.executable, "-c", code)
    assert proc.returncode == 0, proc.stderr
    ranks = sorted(line for line in proc.stdout.splitlines() if line.startswith("rank"))
    assert ranks == ["rank 0 2 0", "rank 1 2 1"]
    proc = run_cli("--no-tcmalloc", "--devices", "3")
    assert proc.returncode == 0 and proc.stdout == "export WORLD_SIZE=3\n"


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
    assert run_cli("--devices", "0").returncode != 0  # no world of no ranks
