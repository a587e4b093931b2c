"""The port's LM launcher (``python -m repro_torch.launch.train``) against
the JAX package's (``repro/launch/train.py``): ``build_dataset`` gives the
reference's int32 token rows exactly (the same corpus from the same seed
through both packages' ``Dataset`` planners); ``main`` at ``--smoke`` on
the CPU trains, checkpoints, and a second run on the same ``--ckpt``
resumes where the first stopped with the saved state; the flags the port
cannot take on one card raise.
"""

import os

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.launch.train import build_dataset as jax_build_dataset
from repro_torch.checkpoint.tree import flatten_with_paths, map_with_paths
from repro_torch.configs import get_smoke
from repro_torch.launch import train

PLANNER_ENV = ("REPRO_BYTES_BACKEND", "REPRO_EXECUTOR", "REPRO_CACHE", "REPRO_CACHE_DIR",
               "REPRO_WORKERS")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps this
    file off the cores the other test files share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def planner_defaults(monkeypatch, tmp_path):
    """Both packages' planners read these; the defaults are under test.
    Temporary directories go under the test's own."""
    for name in PLANNER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)


@pytest.mark.parametrize("arch,seq_len", [("stablelm_3b", 64), ("recurrentgemma_9b", 24)])
def test_build_dataset_gives_the_reference_rows(arch, seq_len):
    got = train.build_dataset(get_smoke(arch), seq_len, 0.3, seed=0, device="cpu")
    want = jax_build_dataset(jax_get_smoke(arch), seq_len, 0.3, seed=0)
    assert got.dtype == np.int32 and got.shape == want.shape and got.shape[0] > 10
    np.testing.assert_array_equal(got, want)


def test_main_trains_then_resumes_from_its_checkpoint(tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    flags = ["--arch", "stablelm_3b", "--smoke", "--device", "cpu", "--corpus-mb", "0.3",
             "--batch", "4", "--seq-len", "32", "--save-every", "3", "--ckpt", ckpt]
    controllers = []

    class Recording(train.TrainController):
        """Keeps each controller and a copy of the state it starts from."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.start = map_with_paths(lambda _, t: t.clone(), (self.params, self.opt_state))
            controllers.append(self)

    monkeypatch.setattr(train, "TrainController", Recording)
    first = train.main(flags + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed" not in out and f"final checkpoint at step 6 in {ckpt}" in out
    assert [h["step"] for h in first] == list(range(1, 7))
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in first)
    assert sorted(os.listdir(ckpt)) == ["step_0000000003", "step_0000000006"]
    assert first[-1]["loss"] < first[0]["loss"]

    second = train.main(flags + ["--steps", "9"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "final checkpoint at step 9" in out
    assert [h["step"] for h in second] == [7, 8, 9]
    assert all(np.isfinite(h["loss"]) for h in second)
    ended, resumed = controllers
    for (path, got), (_, want) in zip(flatten_with_paths(resumed.start),
                                      flatten_with_paths((ended.params, ended.opt_state)),
                                      strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    assert int(resumed.start[1].count) == 6


def test_one_card_flags_raise():
    """On one rank ``--model-parallel 2`` does not divide the world and the
    production mesh needs 256 ranks: each raises with the count it found
    (the mesh itself runs in ``test_the_launcher_trains_over_four_ranks``)."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="world of 1 rank"):
        train.main(["--smoke", "--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        train.main(["--smoke", "--device", "cpu", "--production-mesh"])
    assert not dist.is_initialized()  # the launcher left the group it joined


def test_the_launcher_trains_over_four_ranks(tmp_path):
    """``python -m repro_torch.launch.env --devices 4 -- python -m
    repro_torch.launch.train --smoke --device cpu --model-parallel 2``: four
    ranks on a (2, 2) mesh, the history printed by rank 0 alone, the loss
    falling."""
    import signal
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.env", "--devices", "4", "--no-tcmalloc",
           "--", sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device",
           "cpu", "--model-parallel", "2", "--steps", "3", "--corpus-mb", "0.2", "--ckpt",
           str(tmp_path / "ckpt")]
    proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-6000:]
    assert "mesh={'data': 2, 'model': 2}" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3, out  # one history, rank 0's
    assert losses[-1] < losses[0]
    assert (tmp_path / "ckpt" / "step_0000000003" / "manifest.json").exists()


def test_the_card_is_the_default_device(monkeypatch):
    class Stop(Exception):
        pass

    seen = []

    def build_dataset(cfg, seq_len, corpus_mb, seed, device=None):
        seen.append(device)
        raise Stop

    monkeypatch.setattr(train, "build_dataset", build_dataset)
    with pytest.raises(Stop):
        train.main(["--smoke"])
    assert seen == [torch.device("cuda")]
