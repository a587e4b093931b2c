"""The harness of the mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_decode.py``): one ``gloo`` world of ``WORLD`` CPU
ranks (``torch.distributed.run``, one thread a rank) and JAX processes over
``WORLD`` host devices, all started at once, each with a timeout of its own,
and ``close``, the reference's tolerance for ``pjit`` against one device
(``tests/test_distributed.py:91``). Not a test module: the mesh tests
import it."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 2e-4


def close(got, want, err_msg="", tol=TOL):
    """Within ``tol`` of ``want``, relative to its largest element."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=err_msg)


def _start(cmd: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc: subprocess.Popen, timeout: float) -> str:
    """Wait for ``proc``; kill its whole session on a timeout, so a hung
    collective fails the test and leaves nothing."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s:\n{out[-6000:]}")
    assert proc.returncode == 0, out[-6000:]
    return out


def run_both(jax_script: str, rank_script: str, out: Path, parts: tuple[str, ...],
             timeout: float = 180, serial: bool = False):
    """The JAX side, one process over ``WORLD`` host devices for each of
    ``parts`` (its ``PART``), each of which writes ``OUT/jax_<part>.npz``,
    and the port's side, a world of ``WORLD`` local ranks
    (``torch.distributed.run`` on a free port, one thread each) each of
    which writes ``OUT/rank<r>.npz``, all run at the same time, or with
    ``serial`` the JAX side before the ranks (fewer processes at once,
    beside a suite's other workers); each reads only what the test wrote
    into ``OUT`` first."""
    src = str(ROOT / "src")
    jax_env = dict(os.environ, PYTHONPATH=src, OUT=str(out), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    rank_env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", OUT=str(out))
    ranks = [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={WORLD}", "--no-python", sys.executable, "-c", rank_script]
    procs = [_start([sys.executable, "-c", jax_script], dict(jax_env, PART=part))
             for part in parts]
    try:
        if serial:
            for proc in procs:
                _finish(proc, timeout)
        procs.append(_start(ranks, rank_env))
        for proc in procs:
            if proc.returncode is None:
                _finish(proc, timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    ref = {}
    for part in parts:
        ref.update(np.load(out / f"jax_{part}.npz"))
    return ref, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
