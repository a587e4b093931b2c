"""The port's LM on a mesh (``launch/mesh.py``, ``MeshContext``, DTensor
parameters placed by ``param_axes()`` and ``DEFAULT_RULES``), held against
the JAX package: one ``gloo`` world of 4 CPU ranks on a ``(2, 2)`` mesh of
``(data, model)`` (``torch.distributed.run``, one thread a rank, a timeout
of its own) and two JAX processes (the dense models, the MoE one) over 4
host devices on the reference's ``make_host_mesh(model_parallel=2)``, all
run at once for the file:

* StableLM-3B SMOKE logits at model parallel 2, fed by a sharded
  ``put_sharded`` batch, against JAX's ``pjit`` forward and its
  one-device forward;
* RecurrentGemma-9B and xLSTM-1.3B SMOKE forwards on the mesh (their
  ``rg_lru`` and ``mlstm_chunk`` kernels on each rank's channels and
  heads) against JAX's ``pjit`` forward;
* Qwen2.5-32B SMOKE (GQA 8/2, QKV bias) and DeepSeek-MoE-16B SMOKE (its
  MoE layers on ``moe_ep``): the gradients of the loss, and two sharded
  train steps with 2 microbatches each, the losses held to JAX's sharded
  step, the loss falling, and the parameters after them;
* a masked cross entropy of the vocabulary-sharded StableLM-3B logits
  against the reference's on its own;
* a ``DeviceFeed(sharding=...)`` batch: each rank holds exactly its rows.

Tolerance 2e-4, the reference's own for ``pjit`` against one device
(``tests/test_distributed.py:91``)."""

import numpy as np
import pytest
from torch_mesh_worlds import close, run_both

FORWARDS = ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b")
STEPPED = (("qwen", "qwen2_5_32b"), ("deepseek", "deepseek_moe_16b"))


JAX_SCRIPT = r"""
import os, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed.sharding import tree_shardings
from repro.launch.mesh import make_host_mesh, set_mesh
from repro.models.blocks import cross_entropy_loss
from repro.models.lm import LM, MeshContext
from repro.optim.adamw import AdamW
from repro.runtime.train_loop import TrainStepConfig, make_train_step

mesh = make_host_mesh(model_parallel=2)
mctx = MeshContext(mesh, ("data",), "model")
PART = os.environ["PART"]  # "dense": the forwards and Qwen2.5's steps; "moe": DeepSeek's
STEPPED = (("qwen", "qwen2_5_32b"),) if PART == "dense" else (("deepseek", "deepseek_moe_16b"),)
OUT = os.environ["OUT"]
given = np.load(os.path.join(OUT, "given.npz"))
with open(os.path.join(OUT, "trees.pkl"), "rb") as fh:
    trees = pickle.load(fh)
out = {}

for arch in ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b") if PART == "dense" else ():
    cfg = get_smoke(arch)
    params = trees[arch]
    toks = jnp.asarray(given[f"{arch}/tokens"])
    if arch == "stablelm_3b":  # and one device
        one, _ = jax.jit(LM(cfg, remat=False).forward)(params, {"tokens": toks})
        out[f"{arch}/one"] = np.asarray(one)
    with set_mesh(mesh):
        sh = NamedSharding(mesh, P("data", None))
        logits, _ = jax.jit(LM(cfg, mctx, remat=False).forward)(
            params, {"tokens": jax.device_put(toks, sh)})
    out[f"{arch}/pjit"] = np.asarray(logits)
    if arch == "stablelm_3b":  # a masked loss over the same logits
        out[f"{arch}/masked_nll"] = np.asarray(cross_entropy_loss(
            logits, toks, jnp.asarray(given["mask"])))

for tag, arch in STEPPED:
    cfg = get_smoke(arch)
    model = LM(cfg, mctx, remat=False, dtype=jnp.float32)  # remat changes no value
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model.loss, opt, TrainStepConfig(n_microbatches=2))
    params = trees[tag]
    with set_mesh(mesh):
        sh = tree_shardings(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                         params), model.param_axes(), mesh)
        p = jax.tree.map(jax.device_put, params, sh)
        o = opt.init(p)
        batch = {"tokens": jax.device_put(jnp.asarray(given[f"{tag}/tokens"]),
                                          NamedSharding(mesh, P("data", None)))}
        with open(os.path.join(OUT, f"{tag}_grads.pkl"), "wb") as fh:
            pickle.dump(jax.tree.map(np.asarray, jax.jit(jax.grad(model.loss))(p, batch)), fh)
        jstep = jax.jit(step)
        losses, norms = [], []
        for _ in range(2):
            p, o, m = jstep(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/norms"] = np.asarray(norms)
    with open(os.path.join(OUT, f"{tag}_after.pkl"), "wb") as fh:
        pickle.dump(jax.tree.map(np.asarray, p), fh)
np.savez(os.path.join(OUT, f"jax_{PART}.npz"), **out)
"""

RANK_SCRIPT = r"""
import os
import numpy as np, torch
import torch.distributed as dist
from torch.func import functional_call
torch.set_num_threads(1)
from repro_torch.configs import get_smoke
from repro_torch.core.async_loader import put_sharded
from repro_torch.core.device_pipeline import DeviceFeed
from repro_torch.distributed.sharding import NamedSharding, P, batch_spec, data_axis_names
from repro_torch.models import attention as A, rglru as RG, xlstm as XL
from repro_torch.models.blocks import cross_entropy_loss
from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
from repro_torch.models.lm import LM, MeshContext
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.train_loop import (TrainStepConfig, functional_loss, make_train_step,
                                           value_and_grad)

OUT = os.environ["OUT"]
ref = np.load(os.path.join(OUT, "given.npz"))
mesh = make_host_mesh(2, device="cpu")
rank = dist.get_rank()
mctx = MeshContext(mesh, data_axis_names(mesh), "model")
bsh = NamedSharding(mesh, batch_spec(mesh, 8))
out = {"coord": np.asarray(mesh.get_coordinate())}
seen = {}


def names(placements):
    return np.asarray([f"S{p.dim}" if p.is_shard() else "R" if p.is_replicate() else "P"
                       for p in placements])


def spy(module, name):
    # the wrapper's first argument as the kernel sees it: a plain local tensor
    op = getattr(module, name)

    def wrapped(*args, **kwargs):
        x = args[0]
        seen.setdefault(name, []).append(list(x.shape) if type(x) is torch.Tensor else [-1])
        return op(*args, **kwargs)

    setattr(module, name, wrapped)


spy(A, "flash_attention_op")
spy(RG, "rg_lru_op")
spy(XL, "mlstm_chunk_op")


def model_of(tag, arch, **kw):
    cfg = get_smoke(arch)
    model = LM(cfg, "cpu", mctx=mctx, **kw)
    params = {k[len(tag) + 8:]: torch.from_numpy(ref[k]) for k in ref.files
              if k.startswith(f"{tag}/params/")}
    model.load_state_dict({k.replace("/", "."): v for k, v in params.items()})
    return model, model.distribute_params(params)


for arch in ("stablelm_3b", "recurrentgemma_9b", "xlstm_1_3b"):
    model, params = model_of(arch, arch, remat=False)
    toks = ref[f"{arch}/tokens"]
    # StableLM takes its rows from the sharded feed, the others whole
    tokens = put_sharded(toks, bsh, torch.device("cpu")) if arch == "stablelm_3b" \
        else torch.from_numpy(toks)
    seen.clear()
    logits = functional_call(model, {k.replace("/", "."): v for k, v in params.items()},
                             ({"tokens": tokens},))
    out[f"{arch}/logits"] = logits.full_tensor().numpy()
    out[f"{arch}/placements"] = names(logits.placements)
    if arch == "stablelm_3b":  # a masked loss over the vocabulary-sharded logits
        out[f"{arch}/masked_nll"] = cross_entropy_loss(
            logits, torch.from_numpy(toks), torch.from_numpy(ref["mask"])).full_tensor().numpy()
    for name, shapes in seen.items():
        out[f"{arch}/{name}"] = np.asarray(shapes)

for tag, arch in (("qwen", "qwen2_5_32b"), ("deepseek", "deepseek_moe_16b")):
    model, params = model_of(tag, arch, remat=True)
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(functional_loss(model), opt, TrainStepConfig(2))
    state = opt.init(params)
    batch = {"tokens": put_sharded(ref[f"{tag}/tokens"], bsh, torch.device("cpu"))}
    _, grads = value_and_grad(functional_loss(model))(params, batch)
    for k, g in grads.items():
        out[f"{tag}/grad/{k}"] = g.full_tensor().numpy()
    losses, norms = [], []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/norms"] = np.asarray(norms)
    for k, v in params.items():
        out[f"{tag}/after/{k}"] = v.full_tensor().numpy()
    if tag == "qwen":
        out["qwen/m_placements"] = names(state.m["layers/0/attn/wq"].placements)
    else:  # the experts over the model axis
        out["deepseek/expert_placements"] = names(params["layers/1/moe/w_gate"].placements)

host = [{"x": np.arange(40, dtype=np.int64).reshape(8, 5) + 100 * i} for i in range(3)]
feed = DeviceFeed(iter(host), sharding=NamedSharding(mesh, P("data")), device="cpu", prefetch=1)
out["feed"] = np.stack([b["x"].to_local().numpy() for b in feed])
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
destroy_process_group()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The models' parameters (the reference's ``LM.init``, seed 0) and
    token rows (seed 1) drawn here, then both sides at once."""
    import pickle

    import jax

    from repro.configs import get_smoke as jax_get_smoke
    from repro.models.lm import LM as JaxLM
    from repro_torch.bridge import lm_params_from_jax
    from repro_torch.configs import get_smoke

    given, trees = {}, {}
    for tag, arch in [(a, a) for a in FORWARDS] + list(STEPPED):
        cfg = jax_get_smoke(arch)
        tree = jax.tree.map(np.asarray, jax.jit(JaxLM(cfg, remat=False).init)(
            jax.random.PRNGKey(0)))
        trees[tag] = tree
        given[f"{tag}/tokens"] = np.asarray(
            jax.random.randint(jax.random.PRNGKey(1), (8, 16), 4, cfg.vocab_size))
        for k, v in lm_params_from_jax(tree, get_smoke(arch)).items():
            given[f"{tag}/params/{k}"] = v.numpy()
    # about a third of the positions masked out
    given["mask"] = (np.random.default_rng(2).random((8, 16)) > 0.35).astype(np.float32)
    out = tmp_path_factory.mktemp("mesh")
    np.savez(out / "given.npz", **given)
    with open(out / "trees.pkl", "wb") as fh:
        pickle.dump(trees, fh)
    ref, ranks = run_both(JAX_SCRIPT, RANK_SCRIPT, out, ("dense", "moe"))
    for tag, arch in STEPPED:
        with open(out / f"{tag}_after.pkl", "rb") as fh:
            after = lm_params_from_jax(pickle.load(fh), get_smoke(arch))
        ref.update({f"{tag}_after/params/{k}": v.numpy() for k, v in after.items()})
        with open(out / f"{tag}_grads.pkl", "rb") as fh:
            grads = lm_params_from_jax(pickle.load(fh), get_smoke(arch))
        ref.update({f"{tag}/grad/{k}": v.numpy() for k, v in grads.items()})
    return {**given, **ref}, ranks


@pytest.mark.parametrize("arch", FORWARDS)
def test_forward_on_the_mesh_is_the_references(worlds, arch):
    ref, ranks = worlds
    got = ranks[0][f"{arch}/logits"]
    close(got, ref[f"{arch}/pjit"])
    if arch == "stablelm_3b":
        close(got, ref[f"{arch}/one"])
    for other in ranks[1:]:  # every rank holds the same logits
        np.testing.assert_array_equal(other[f"{arch}/logits"], got)


@pytest.mark.parametrize("arch, op, local", [
    ("stablelm_3b", "flash_attention_op", [4, 16, 2, 16]),  # 8 rows / 2, 4 heads / 2
    ("recurrentgemma_9b", "flash_attention_op", [4, 16, 4, 16]),  # 1 kv head: whole heads
    ("recurrentgemma_9b", "rg_lru_op", [4, 16, 32]),  # 64 channels / 2
    ("xlstm_1_3b", "mlstm_chunk_op", [4, 16, 2, 16]),  # 4 heads / 2
])
def test_the_kernels_run_on_local_shards(worlds, arch, op, local):
    """Each kernel wrapper got plain local tensors, this rank's rows and
    channels or heads (on the CPU it runs its plain version), once a layer
    of its kind."""
    _, ranks = worlds
    for got in ranks:
        shapes = got[f"{arch}/{op}"]
        assert len(shapes) > 0 and all(list(s) == local for s in shapes), shapes
    # rows over the data axis, the vocabulary over the model axis (the
    # residual anchored after each block): the head's weight stays sharded
    # and no rank holds all the logits
    assert list(ranks[0][f"{arch}/placements"]) == ["S0", "S2"]


def test_a_masked_loss_on_the_mesh_is_the_references(worlds):
    """``cross_entropy_loss`` of vocabulary-sharded logits weighs each
    position by ``mask`` and divides by Σmask, as the reference does."""
    ref, ranks = worlds
    assert 0 < ref["mask"].sum() < ref["mask"].size
    for got in ranks:
        close(got["stablelm_3b/masked_nll"], ref["stablelm_3b/masked_nll"])


def _steps_are_the_references(ref, ranks, tag):
    """The two steps' losses and gradient norms, and the first step's
    gradient of every leaf (relative to its largest element), on every
    rank; the loss falls."""
    grads = [k for k in ref if k.startswith(f"{tag}/grad/")]
    assert grads
    for got in ranks:
        close(got[f"{tag}/losses"], ref[f"{tag}/losses"])
        close(got[f"{tag}/norms"], ref[f"{tag}/norms"])
        for k in grads:
            close(got[k], ref[k], err_msg=k)
    assert ranks[0][f"{tag}/losses"][1] < ranks[0][f"{tag}/losses"][0]
    after = {k[len(f"{tag}_after/params/"):]: v for k, v in ref.items()
             if k.startswith(f"{tag}_after/params/")}
    assert after
    return after


def test_sharded_train_steps_are_the_references(worlds):
    ref, ranks = worlds
    after = _steps_are_the_references(ref, ranks, "qwen")
    for k, want in after.items():  # each update held relative to its largest element
        before = ref[f"qwen/params/{k}"]
        close(ranks[0][f"qwen/after/{k}"] - before, want - before, err_msg=k)
    # the moments are placed as their parameters: wq's heads over the model axis
    assert list(ranks[0]["qwen/m_placements"]) == ["R", "S1"]


def test_sharded_moe_train_steps_are_the_references(worlds):
    """DeepSeek-MoE-16B SMOKE: its MoE layers take ``moe_ep`` (8 experts, 4
    a rank), so the steps hold the expert-parallel backward to the
    reference's jitted step. The parameters after the steps are held
    relative to each leaf's largest element, not their updates: where a
    router element's gradients of the two steps nearly cancel, AdamW's
    m/√v turns their last bits (the gradients agree to about 1e-6 of the
    largest) into an update that differs by some 4e-4 of the largest."""
    ref, ranks = worlds
    after = _steps_are_the_references(ref, ranks, "deepseek")
    for k, want in after.items():
        close(ranks[0][f"deepseek/after/{k}"], want, err_msg=k)
    assert list(ranks[0]["deepseek/expert_placements"]) == ["R", "S0"]


def test_each_rank_holds_exactly_its_rows(worlds):
    _, ranks = worlds
    host = np.stack([np.arange(40).reshape(8, 5) + 100 * i for i in range(3)])
    seen = set()
    for got in ranks:
        data = int(got["coord"][0])
        np.testing.assert_array_equal(got["feed"], host[:, 4 * data: 4 * data + 4])
        seen.add(data)
    assert seen == {0, 1}
