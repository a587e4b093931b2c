"""The port's checkpoints and ``TrainController``: atomic save and restore,
retention, the async save's errors, resume (also after SIGKILL), and the
on-disk layout shared with the JAX package: a checkpoint of
``(params, AdamWState)`` written by either package restores in the other
with bit-equal leaves and dtypes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs.p3sapp_summarizer import SMOKE as JAX_SMOKE
from repro.models.seq2seq import Seq2Seq as JaxSeq2Seq
from repro.optim.adamw import AdamW as JaxAdamW, AdamWState as JaxAdamWState
from repro.runtime.fault_tolerance import TrainController as JaxTrainController
from repro_torch.bridge import (
    adamw_state_from_jax,
    adamw_state_to_jax,
    from_jax_params,
    to_jax_params,
)
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.tree import flatten_with_paths
from repro_torch.configs.p3sapp_summarizer import SMOKE
from repro_torch.models.seq2seq import Seq2Seq
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime.fault_tolerance import Heartbeat, TrainController
from repro_torch.runtime.train_loop import functional_loss, make_train_step, params_of

ROOT = Path(__file__).resolve().parents[1]


def tree_equal(a, b):
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x, y), path


def sample_tree():
    state = AdamWState(torch.tensor(7, dtype=torch.int32),
                       {"w": torch.arange(6.0).reshape(2, 3)},
                       {"w": torch.ones(2, 3, dtype=torch.bfloat16)})
    return ({"a": torch.arange(6).reshape(2, 3), "b": [torch.ones(4), {"c": torch.zeros(2)}]},
            state)


def test_save_restore_round_trip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = sample_tree()
    ck.save(10, tree, extra={"step": 10})
    restored, extra = ck.restore(tree, device="cpu")
    assert extra == {"step": 10}
    assert isinstance(restored[1], AdamWState)
    tree_equal(restored, tree)
    manifest = json.loads((tmp_path / "step_0000000010" / "manifest.json").read_text())
    paths = [e["path"] for e in manifest["leaves"]]
    assert paths == ["0/a", "0/b/0", "0/b/1/c", "1/count", "1/m/w", "1/v/w"]
    assert [e["dtype"] for e in manifest["leaves"]][3:] == ["int32", "float32", "bfloat16"]


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.latest() == 4
    assert ck.steps() == [3, 4]


def test_partial_write_is_invisible(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"w": torch.ones(3)}
    ck.save(1, tree)
    (tmp_path / "step_0000000002.tmp").mkdir()
    (tmp_path / "step_0000000002.tmp" / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest() == 1
    restored, _ = ck.restore(tree, device="cpu")
    tree_equal(restored, tree)


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        ck.restore({"v": torch.ones(3)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore({"w": torch.ones(1)}, device="cpu")


def test_async_save_snapshots_and_surfaces_errors(tmp_path):
    ck = Checkpointer(tmp_path)
    w = torch.zeros(3)
    ck.save_async(1, {"w": w})
    w += 5  # after the snapshot: the checkpoint keeps zeros
    ck.wait()
    restored, _ = ck.restore({"w": w}, device="cpu")
    assert torch.equal(restored["w"], torch.zeros(3))
    (tmp_path / "step_0000000002.tmp").write_text("a file where the directory goes")
    ck.save_async(2, {"w": w})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is raised once
    assert ck.latest() == 1


# -- TrainController --------------------------------------------------------------


def counting_step(params, opt, batch):
    return {k: v + 1 for k, v in params.items()}, opt, {"loss": torch.tensor(1.0)}


def counting_state():
    return {"w": torch.zeros(2)}, {"m": torch.zeros(2)}


def test_controller_resumes(tmp_path):
    hb = tmp_path / "hb"
    c1 = TrainController(tmp_path, counting_step, counting_state, save_every=2,
                         heartbeat=Heartbeat(hb, interval_s=0.0))
    history = c1.run(iter([None] * 5), n_steps=5)
    assert c1.step == 5 and [h["step"] for h in history] == [1, 2, 3, 4, 5]
    assert history[0]["loss"] == 1.0 and Heartbeat.is_alive(hb, timeout_s=60.0)
    c2 = TrainController(tmp_path, counting_step, counting_state, save_every=2)
    assert c2.resumed and c2.step == 5 and float(c2.params["w"][0]) == 5.0
    c2.run(iter([None] * 3), n_steps=8)
    assert c2.step == 8


_KILL_SCRIPT = r"""
import os, signal, sys
sys.path.insert(0, SRC)
import torch
from repro_torch.runtime.fault_tolerance import TrainController

def init_state():
    return {"w": torch.zeros(2)}, {"m": torch.zeros(2)}

def step(params, opt, batch):
    return {"w": params["w"] + 1}, opt, {"loss": torch.tensor(0.0)}

c = TrainController(CKPT, step, init_state, save_every=5)
save = c.ckpt.save

def save_then_die(step, tree, extra=None):
    path = save(step, tree, extra)
    if step == KILL_AT:
        os.kill(os.getpid(), signal.SIGKILL)
    return path

c.ckpt.save = save_then_die
c.run(iter([None] * 1000), n_steps=1000)
"""


def test_kill_and_resume(tmp_path):
    """A child SIGKILLs itself right after committing step 15; the restart
    resumes at exactly 15."""
    script = (_KILL_SCRIPT.replace("SRC", repr(str(ROOT / "src")))
              .replace("CKPT", repr(str(tmp_path))).replace("KILL_AT", "15"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -9, proc.stderr
    c = TrainController(tmp_path, counting_step, counting_state, save_every=5)
    assert c.resumed and c.step == 15 and float(c.params["w"][0]) == 15.0


# -- across the two packages ---------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        enc = rng.integers(4, SMOKE.vocab_size, size=(4, 10)).astype(np.int32)
        dec = rng.integers(4, SMOKE.vocab_size, size=(4, 6)).astype(np.int32)
        dec[:, 0], dec[:, -1] = 1, 2
        out.append({"encoder_tokens": enc, "decoder_tokens": dec})
    return out


def test_key_paths_are_jax_paths():
    """NamedTuple fields by name, dict keys sorted, list items by index:
    the leaf paths of JAX's checkpointer for (params, AdamWState)."""
    from repro.checkpoint.checkpointer import _flatten_with_paths

    params = JaxSeq2Seq(JAX_SMOKE).init(jax.random.PRNGKey(0))
    jtree = (params, JaxAdamW().init(params))
    want = [p for p, _ in _flatten_with_paths(jtree)[0]]
    port = (from_jax_params(params), adamw_state_from_jax(jtree[1]))
    got = [p for p, _ in flatten_with_paths(port)]
    assert sorted(got) == sorted(want)
    assert {"0/encoder/0/wx", "0/out_b", "1/count", "1/m/encoder/0/wx", "1/v/out_b"} <= set(got)


def test_jax_checkpoint_restores_in_the_port(tmp_path, smoke_batches):
    jmodel, jopt = JaxSeq2Seq(JAX_SMOKE), JaxAdamW(learning_rate=1e-3)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jmodel.loss)(params, batch)
        params, opt_state, gnorm = jopt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def jinit():
        params = jmodel.init(jax.random.PRNGKey(0))
        return params, jopt.init(params)

    jc = JaxTrainController(tmp_path, jstep, jinit, save_every=2)
    jc.run(iter([{k: jnp.asarray(v) for k, v in b.items()} for b in smoke_batches]), n_steps=3)
    model = Seq2Seq(SMOKE, "cpu", seed=1)
    opt = AdamW()

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    pc = TrainController(tmp_path, make_train_step(functional_loss(model), opt), init_state)
    assert pc.resumed and pc.step == 3
    want = (from_jax_params(jc.params), adamw_state_from_jax(jc.opt_state))
    tree_equal(pc.params, want[0])
    assert pc.opt_state.count.dtype == torch.int32 and int(pc.opt_state.count) == 3
    tree_equal(pc.opt_state, want[1])


def test_port_checkpoint_restores_in_jax(tmp_path, smoke_batches):
    model = Seq2Seq(SMOKE, "cpu", seed=2)
    opt = AdamW(learning_rate=1e-3)

    def init_state():
        params = params_of(model)
        return params, opt.init(params)

    pc = TrainController(tmp_path, make_train_step(functional_loss(model), opt), init_state,
                         save_every=2)
    pc.run(iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in smoke_batches]),
           n_steps=3)
    jmodel = JaxSeq2Seq(JAX_SMOKE)
    like_params = jmodel.init(jax.random.PRNGKey(0))
    like = (like_params, JaxAdamW().init(like_params))
    (params, state), extra = JaxCheckpointer(tmp_path).restore(like)
    assert extra == {"step": 3}
    state = JaxAdamWState(*state)
    want_params, want_state = to_jax_params(pc.params), adamw_state_to_jax(pc.opt_state)
    got = jax.tree_util.tree_leaves_with_path((params, state))
    ref = jax.tree_util.tree_leaves((want_params, want_state))
    assert len(got) == len(ref) == len(flatten_with_paths((pc.params, pc.opt_state)))
    for (path, g), w in zip(got, ref, strict=True):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert np.asarray(state.count).dtype == np.int32 and int(state.count) == 3
    assert os.path.isdir(tmp_path / "step_0000000002")
