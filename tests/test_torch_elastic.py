"""Elastic re-meshing (``repro_torch.runtime.elastic``) and checkpoints
across meshes (``Checkpointer.save``/``restore(shardings=...)``,
``TrainController(shardings=...)``) in one ``gloo`` world of 4 CPU ranks
(``torch.distributed.run``, one thread a rank, a timeout of its own):

* ``remesh`` of a tree from a ``(2, 2)`` mesh to ``(1, 4)`` to ``(1, 1)``
  (rank 0 alone), bit for bit, each leaf placed as the reference's
  ``spec_for`` places it on that mesh, each rank holding its block;
* ``available_mesh``'s shapes, the model axis lowered until it divides,
  as ``repro/runtime/elastic.py:31`` lowers it;
* StableLM-3B SMOKE's parameters and AdamW state after a step on the
  ``(2, 2)`` mesh saved (rank 0 writes, behind a barrier) and restored on
  the ``(1, 4)`` mesh bit for bit, and a ``TrainController`` resuming
  there and stepping on."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.distributed.sharding import spec_for as ref_spec_for

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def run_ranks(script: str, out: Path, timeout: float = 120) -> list[dict]:
    """``script`` as a world of ``WORLD`` local ranks (``torch.distributed.run``
    on a free port, one thread each); each rank writes ``OUT/rank<r>.npz``.
    On a timeout the whole session is killed, so a hung collective fails
    the test and leaves nothing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", OUT=str(out))
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={WORLD}", "--no-python", sys.executable, "-c",
                             script], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s:\n{text[-6000:]}")
    assert proc.returncode == 0, text[-6000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


TREE = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
        "v": np.ones(8, np.float32),
        "e": np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8) / 7}
AXES = {"w": ("embed", "mlp"), "v": ("embed",), "e": ("experts", "embed", "expert_ff")}

RANK_SCRIPT = r"""
import os
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import data_axis_names
from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
from repro_torch.models.lm import LM, MeshContext
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime.elastic import available_mesh, remesh
from repro_torch.runtime.fault_tolerance import TrainController
from repro_torch.runtime.train_loop import params_of
from repro_torch.runtime.train_loop import TrainStepConfig, functional_loss, make_train_step

OUT = os.environ["OUT"]
out = {}


def names(placements):
    return np.asarray([f"S{p.dim}" if p.is_shard() else "R" for p in placements])


tree = {"w": torch.arange(64.0).reshape(8, 8), "v": torch.ones(8),
        "e": torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8) / 7}
axes = {"w": ("embed", "mlp"), "v": ("embed",), "e": ("experts", "embed", "expert_ff")}
mesh22 = make_host_mesh(2, device="cpu")
rank = dist.get_rank()
meshes = [("2x2", mesh22), ("1x4", available_mesh(4)), ("1x1", available_mesh(1, ranks=[0]))]
current = tree
for tag, mesh in meshes:
    current = remesh(current, axes, mesh)
    if mesh.get_coordinate() is None:
        continue
    for k, t in current.items():
        out[f"{tag}/{k}/placements"] = names(t.placements)
        out[f"{tag}/{k}/local"] = t.to_local().numpy()
        if tag != "1x1":
            out[f"{tag}/{k}/full"] = t.full_tensor().numpy()
    out[f"{tag}/coord"] = np.asarray(mesh.get_coordinate())
    out[f"{tag}/shape"] = np.asarray(mesh.shape)
if rank == 0:
    for k, t in current.items():
        out[f"1x1/{k}/full"] = t.full_tensor().numpy()
for n, mp in ((3, 2), (3, 3), (4, 3), (2, 4)):
    out[f"available/{n}/{mp}"] = np.asarray(available_mesh(mp, ranks=list(range(n))).shape)

# checkpoint on (2, 2), restore on (1, 4)
cfg = get_smoke("stablelm_3b")
opt = AdamW(learning_rate=1e-3)
model = LM(cfg, "cpu", mctx=MeshContext(mesh22, data_axis_names(mesh22), "model"))
params = model.distribute_params(params_of(model))
step = make_train_step(functional_loss(model), opt, TrainStepConfig(), donate=True)
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(4, cfg.vocab_size, (8, 16), generator=g)}
params, state, _ = step(params, opt.init(params), batch)
ckpt = os.path.join(OUT, "ckpt")
Checkpointer(ckpt).save(1, (params, state), extra={"step": 1})
saved = {k: t.full_tensor().numpy() for k, t in params.items()}
saved_m = {k: t.full_tensor().numpy() for k, t in state.m.items()}
mesh14 = meshes[1][1]
model14 = LM(cfg, "cpu", mctx=MeshContext(mesh14, data_axis_names(mesh14), "model"))
sh = model14.param_shardings()
like = params_of(model14)
(rp, rs), extra = Checkpointer(ckpt).restore((like, AdamWState(torch.zeros((), dtype=torch.int32),
                                                               like, like)),
                                             shardings=(sh, AdamWState(None, sh, sh)))
out["ckpt/equal"] = np.asarray(
    all(np.array_equal(rp[k].full_tensor().numpy(), v) for k, v in saved.items())
    and all(np.array_equal(rs.m[k].full_tensor().numpy(), v) for k, v in saved_m.items()))
out["ckpt/count"] = np.asarray(int(rs.count))
out["ckpt/wq"] = names(rp["layers/0/attn/wq"].placements)
step14 = make_train_step(functional_loss(model14), opt, TrainStepConfig(), donate=True)


def init_state():
    p = model14.distribute_params(params_of(model14))
    return p, opt.init(p)


ctl = TrainController(ckpt, step14, init_state, shardings=(sh, AdamWState(None, sh, sh)))
out["ctl/resumed"] = np.asarray([ctl.resumed, ctl.step])
hist = ctl.run(iter([batch] * 3), n_steps=3)
out["ctl/losses"] = np.asarray([h["loss"] for h in hist])
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(RANK_SCRIPT, tmp_path_factory.mktemp("elastic"))


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def expected_placements(shape, axes, mesh_shape) -> list[str]:
    """The reference's spec on that mesh as DTensor placements (a mesh
    dimension of one rank replicates: it holds every element either way)."""
    spec = tuple(ref_spec_for(shape, axes, FakeMesh(mesh_shape)))
    out = []
    for name, size in mesh_shape.items():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"S{dims[0]}" if dims and size > 1 else "R")
    return out


@pytest.mark.parametrize("tag, mesh_shape", [("2x2", {"data": 2, "model": 2}),
                                             ("1x4", {"data": 1, "model": 4}),
                                             ("1x1", {"data": 1, "model": 1})])
def test_remesh_places_each_leaf_by_the_rules_bit_for_bit(ranks, tag, mesh_shape):
    members = [r for r in ranks if f"{tag}/coord" in r]
    assert len(members) == int(np.prod(list(mesh_shape.values())))
    for got in members:
        assert list(got[f"{tag}/shape"]) == list(mesh_shape.values())
        coord = dict(zip(mesh_shape, got[f"{tag}/coord"]))
        for k, full in TREE.items():
            want = expected_placements(full.shape, AXES[k], mesh_shape)
            assert list(got[f"{tag}/{k}/placements"]) == want, (tag, k)
            block = full
            for name, pl in zip(mesh_shape, want):
                if pl != "R":
                    block = np.array_split(block, mesh_shape[name], axis=int(pl[1:]))[
                        coord[name]]
            np.testing.assert_array_equal(got[f"{tag}/{k}/local"], block)
    for k, full in TREE.items():  # the round trip changed no bit
        np.testing.assert_array_equal(members[0][f"{tag}/{k}/full"], full)


def test_available_mesh_lowers_the_model_axis_until_it_divides(ranks):
    for n, mp in ((3, 2), (3, 3), (4, 3), (2, 4)):
        m = mp
        while n % m:  # repro/runtime/elastic.py:36-38
            m -= 1
        for got in ranks:
            assert list(got[f"available/{n}/{mp}"]) == [n // m, m]


def test_a_checkpoint_saved_on_one_mesh_restores_on_another(ranks):
    for got in ranks:
        assert bool(got["ckpt/equal"])
        assert int(got["ckpt/count"]) == 1
        assert list(got["ckpt/wq"]) == ["R", "S1"]  # heads over the 4-way model axis


def test_the_controller_resumes_on_the_new_mesh_and_steps(ranks):
    for got in ranks:
        assert list(got["ctl/resumed"]) == [1, 1]
        losses = got["ctl/losses"]
        assert len(losses) == 2 and np.isfinite(losses).all()
        np.testing.assert_array_equal(losses, ranks[0]["ctl/losses"])
