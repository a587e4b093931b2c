"""The port's expert-parallel MoE (``models/moe.py:moe_ep``) against the
JAX package's ``moe_ep`` on the same ``(2, 2)`` mesh of ``(data, model)``:
one ``gloo`` world of 4 CPU ranks (``torch.distributed.run``, one thread a
rank, a timeout of its own) and one JAX process over 4 host devices, each
run once for the file. DeepSeek-MoE-16B SMOKE (8 experts, top 2, 4 a
rank), at ``capacity_factor`` 8.0 (nothing drops; also equal to
``moe_local``), 1.0 and 0.5, where assignments past a shard's capacity
drop and the same ones must drop (this input's routing fills no shard past
1.0, so the drops show at 0.5): ``y`` and ``aux`` at 2e-4. This is tighter than the reference's 2e-2 on
``aux`` against ``moe_local`` (``tests/test_distributed.py:118``): both
sides average the same per-shard terms. ``moe_ep``'s gradients (of
Σ y·w + 3·aux, nothing dropped) against ``jax.grad`` through the
reference's ``moe_ep`` and against the same function composed on one
process from ``moe_local`` per data shard; ``apply_moe`` taking ``moe_ep`` on the mesh; and on a ``(4,
1)`` mesh ``apply_moe``'s local path, with the load-balance term of the
whole batch, against ``moe_local`` over the whole batch."""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import moe as M

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 2e-4


def close(got, want, err_msg=""):
    """Within 2e-4 of ``want``, relative to its largest element (the SMOKE
    layer's outputs and gradients are of order 1e-6 to 1e-2)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=err_msg)


def dropped_rows(y, y_local):
    """Tokens whose output is not the local path's: one of their
    assignments dropped."""
    return np.abs(y - y_local).max(-1) > 1e-3 * np.abs(y_local).max()
FACTORS = (8.0, 1.0, 0.5)


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


def run_both(jax_script: str, rank_script: str, out: Path, timeout: float = 180):
    """The JAX side, one process over ``WORLD`` host devices that writes
    ``OUT/jax.npz``, and the port's side, a world of ``WORLD`` local ranks
    (``torch.distributed.run`` on a free port, one thread each) each of
    which writes ``OUT/rank<r>.npz``, run at the same time; both read only
    what the test wrote into ``OUT`` first."""
    src = str(ROOT / "src")
    jax_env = dict(os.environ, PYTHONPATH=src, OUT=str(out), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    rank_env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", OUT=str(out))
    procs = [_start([sys.executable, "-c", jax_script], jax_env),
             _start([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     f"--nproc-per-node={WORLD}", "--no-python", sys.executable, "-c",
                     rank_script], rank_env)]
    try:
        for proc in procs:
            _finish(proc, timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return (dict(np.load(out / "jax.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)])


JAX_SCRIPT = r"""
import os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.mesh import make_host_mesh, set_mesh
from repro.models import moe as MOE

cfg = get_smoke("deepseek_moe_16b")
mesh = make_host_mesh(model_parallel=2)
given = np.load(os.path.join(os.environ["OUT"], "given.npz"))
x = jnp.asarray(given["x"])
p = {k[2:]: jnp.asarray(given[k]) for k in given.files if k.startswith("p/") and
     "shared" not in k}
p["shared"] = {k[9:]: jnp.asarray(given[k]) for k in given.files if k.startswith("p/shared/")}
out = {}
for cf in (8.0, 1.0, 0.5):
    object.__setattr__(cfg.moe, "capacity_factor", cf)
    with set_mesh(mesh):
        xd = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        y, aux = jax.jit(lambda p, x: MOE.moe_ep(p, x, cfg, mesh, ("data",), "model"))(p, xd)
    yl, auxl = MOE.moe_local(p, x, cfg)
    out[f"{cf}/y"], out[f"{cf}/aux"] = np.asarray(y), np.asarray(aux)
    out[f"{cf}/y_local"], out[f"{cf}/aux_local"] = np.asarray(yl), np.asarray(auxl)

# the gradients of Σ y·w + 3·aux through moe_ep, nothing dropped
object.__setattr__(cfg.moe, "capacity_factor", 8.0)
w = jnp.asarray(given["w"])
keys = ("router", "w_gate", "w_up", "w_down")


def objective(pp, x):
    y, aux = MOE.moe_ep(pp, x, cfg, mesh, ("data",), "model")
    return jnp.sum(y * w) + 3.0 * aux


with set_mesh(mesh):
    xd = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    g_p, g_x = jax.jit(jax.grad(objective, argnums=(0, 1)))({k: p[k] for k in keys}, xd)
for k in keys:
    out[f"grad/{k}"] = np.asarray(g_p[k])
out["grad/x"] = np.asarray(g_x)
np.savez(os.path.join(os.environ["OUT"], "jax.npz"), **out)
"""

RANK_SCRIPT = r"""
import dataclasses, os
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
torch.set_num_threads(1)
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import destroy_process_group, make_host_mesh, replicate_plain
from repro_torch.models import moe as M
from repro_torch.runtime.elastic import available_mesh

OUT = os.environ["OUT"]
ref = np.load(os.path.join(OUT, "given.npz"))
mesh = make_host_mesh(2, device="cpu")
rank = dist.get_rank()
base = get_smoke("deepseek_moe_16b")
plain = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files if k.startswith("p/")}
tree = {"router": plain["router"], "w_gate": plain["w_gate"], "w_up": plain["w_up"],
        "w_down": plain["w_down"],
        "shared": {k: plain[f"shared/{k}"] for k in ("gate", "up", "down")}}
x = torch.from_numpy(ref["x"])
w = torch.from_numpy(ref["w"])
out = {}


def place(t, pl):
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def on_mesh(grad):
    ex = [Replicate(), Shard(0)]  # experts over the model axis
    rep = [Replicate(), Replicate()]
    p = {"router": place(tree["router"], rep),
         **{k: place(tree[k], ex) for k in ("w_gate", "w_up", "w_down")},
         "shared": {k: place(v, rep) for k, v in tree["shared"].items()}}
    xd = place(x, [Shard(0), Replicate()])
    if grad:
        for t in (p["router"], p["w_gate"], p["w_up"], p["w_down"], xd):
            t.requires_grad_(True)
    return p, xd


for cf in (8.0, 1.0, 0.5):
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    p, xd = on_mesh(grad=False)
    y, aux = M.moe_ep(p, xd, cfg, mesh, ("data",), "model")
    out[f"{cf}/y"], out[f"{cf}/aux"] = y.full_tensor().numpy(), aux.full_tensor().numpy()
    y2, aux2 = M.apply_moe(p, xd, cfg, mesh=mesh, data_axes=("data",), model_axis="model")
    out[f"{cf}/apply_y"] = y2.full_tensor().numpy()
    out[f"{cf}/apply_aux"] = aux2.full_tensor().numpy()

cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
p, xd = on_mesh(grad=True)
y, aux = M.moe_ep(p, xd, cfg, mesh, ("data",), "model")
with replicate_plain():  # w, a plain tensor, is replicated (its backward's too)
    ((y * w).sum() + 3.0 * aux).full_tensor().backward()
for k in ("router", "w_gate", "w_up", "w_down"):
    out[f"grad/{k}"] = p[k].grad.full_tensor().numpy()
out["grad/x"] = xd.grad.full_tensor().numpy()

# a (4, 1) mesh: no expert parallelism, moe_local on each data shard
mesh41 = available_mesh(1)
rep = [Replicate(), Replicate()]
p41 = {k: distribute_tensor(v, mesh41, rep, src_data_rank=None) for k, v in tree.items()
       if k != "shared"}
p41["shared"] = {k: distribute_tensor(v, mesh41, rep, src_data_rank=None)
                 for k, v in tree["shared"].items()}
x41 = distribute_tensor(x, mesh41, [Shard(0), Replicate()], src_data_rank=None)
y, aux = M.apply_moe(p41, x41, base, mesh=mesh41, data_axes=("data",), model_axis="model")
out["local/y"], out["local/aux"] = y.full_tensor().numpy(), aux.full_tensor().numpy()
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The layer's parameters (``repro.models.moe.init_moe``, seed 0) and
    ``x`` (seed 1) drawn here, then both sides at once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jax_get_smoke
    from repro.models import moe as JM

    cfg = jax_get_smoke("deepseek_moe_16b")
    given = {"x": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model)))
             * np.float32(0.5)}
    given["w"] = np.random.default_rng(3).standard_normal(given["x"].shape).astype(np.float32)
    for k, v in JM.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32).items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            given[f"p/{k}" if kk is None else f"p/{k}/{kk}"] = np.asarray(vv)
    out = tmp_path_factory.mktemp("moe_ep")
    np.savez(out / "given.npz", **given)
    ref, ranks = run_both(JAX_SCRIPT, RANK_SCRIPT, out)
    return {**given, **ref}, ranks


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ep_is_the_references(worlds, cf):
    ref, ranks = worlds
    for got in ranks:
        close(got[f"{cf}/y"], ref[f"{cf}/y"])
        close(got[f"{cf}/aux"], ref[f"{cf}/aux"])


@pytest.mark.parametrize("cf", FACTORS[1:])
def test_past_capacity_the_references_tokens_drop(worlds, cf):
    """Where a token lost an assignment its output is not the local path's;
    the port's output equals the reference's row for row, so the same
    tokens lose the same assignments. At 0.5 some do and some do not."""
    ref, ranks = worlds
    dropped = dropped_rows(ref[f"{cf}/y"], ref[f"{cf}/y_local"])
    if cf == 0.5:
        assert dropped.any() and not dropped.all()
    for got in ranks:
        got_dropped = dropped_rows(got[f"{cf}/y"], ref[f"{cf}/y_local"])
        np.testing.assert_array_equal(got_dropped, dropped)


def test_without_drops_moe_ep_is_moe_local(worlds):
    ref, ranks = worlds
    close(ranks[0]["8.0/y"], ref["8.0/y_local"])
    np.testing.assert_allclose(ranks[0]["8.0/aux"], ref["8.0/aux_local"], rtol=2e-2)


@pytest.mark.parametrize("cf", FACTORS)
def test_apply_moe_takes_moe_ep_on_the_mesh(worlds, cf):
    ref, ranks = worlds
    x = torch.from_numpy(ref["x"])
    sp = {k: torch.from_numpy(np.array(ref[f"p/shared/{k}"])) for k in ("gate", "up", "down")}
    shared = M._glu(x, sp["gate"], sp["up"], sp["down"]).numpy()
    close(ranks[0][f"{cf}/apply_y"], ref[f"{cf}/y"] + shared)
    close(ranks[0][f"{cf}/apply_aux"], ref[f"{cf}/aux"])


def test_moe_ep_gradients_are_the_per_shard_functions(worlds):
    """The gradient of Σ y·w + 3·aux: ``moe_ep`` is ``moe_local`` on each
    data shard with the shards' load-balance terms averaged, when nothing
    drops; that function on one process gives the gradients to hold it to."""
    ref, ranks = worlds
    base = get_smoke("deepseek_moe_16b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    leaves = {k: torch.from_numpy(ref[f"p/{k}"]).requires_grad_(True)
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    w = torch.from_numpy(ref["w"])
    ys, auxes = zip(*(M.moe_local(leaves, part, cfg) for part in x.chunk(2)))
    loss = (torch.cat(ys) * w).sum() + 3.0 * torch.stack(auxes).mean()
    loss.backward()
    for got in ranks:
        for k, t in leaves.items():
            close(got[f"grad/{k}"], t.grad.numpy(), err_msg=k)
        close(got["grad/x"], x.grad.numpy())


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_up", "w_down", "x"])
def test_moe_ep_gradients_are_the_references(worlds, leaf):
    """The gradient of Σ y·w + 3·aux through the port's ``moe_ep`` (its
    1/n_shards on the expert slices' gradients, the data axes' partial
    sums, the router's and ``x``'s) against ``jax.grad`` through the
    reference's ``moe_ep`` on the same mesh, on every rank."""
    ref, ranks = worlds
    for got in ranks:
        close(got[f"grad/{leaf}"], ref[f"grad/{leaf}"], err_msg=leaf)


def test_apply_moe_on_a_data_only_mesh_is_moe_local_over_the_batch(worlds):
    ref, ranks = worlds
    x = torch.from_numpy(ref["x"])
    tree = {k: torch.from_numpy(ref[f"p/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    tree["shared"] = {k: torch.from_numpy(ref[f"p/shared/{k}"]) for k in ("gate", "up", "down")}
    y, aux = M.apply_moe(tree, x, get_smoke("deepseek_moe_16b"))
    for got in ranks:
        close(got["local/y"], y.numpy())
        close(got["local/aux"], aux.numpy())
