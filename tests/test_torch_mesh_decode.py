"""The port's ``LM.decode_step`` on a mesh, held against the JAX package's
sharded decode step: three JAX processes over 4 host devices on the
reference's ``make_host_mesh(model_parallel=2)``, then one ``gloo`` world
of 4 CPU ranks on a ``(2, 2)`` mesh of ``(data, model)``, once for the
file (``torch_mesh_worlds.run_both``; at most 4 processes at once).

The JAX side builds the decode as the reference's dry run does
(``repro/launch/dryrun.py:238-290``): ``jax.jit(decode_step,
in_shardings=(param_sh, batch_sh, state_sh, repl), out_shardings=(logits_sh,
state_sh))``, the parameters placed by ``param_axes()``, the state by
``tree_shardings(state, decode_state_axes(), mesh)`` and the logits by the
batch's spec; a block prefill at position 0 the same with the position
fixed. The port's side takes DTensor parameters (``distribute_params``),
the DTensor state of ``init_decode_state`` and ``functional_decode``. Both
draw the same parameters (the port's seeded ones through
``repro_torch.bridge``) and prompts (numpy, seeded).

Each case is a block prefill and one-token steps, greedy (the bf16 case
steps through given tokens), at SMOKE with ``init_scale`` 1 so that every
layer moves the logits: every decoder family of ``ARCH_IDS`` in fp32,
batch 4, a prefill of 8 and 4 steps; RecurrentGemma-9B past its ring
window of 16; batch 1 (``long_500k``'s global batch, replicated over
``data``) for RecurrentGemma-9B and xLSTM-1.3B; xLSTM-1.3B with one head
(``rnn`` then takes the model axis, so the mLSTM state is gathered for the
kernel and written back); StableLM-3B in bf16 with a bf16 cache; the MoE
families with a capacity that drops nothing.

Held: the logits of every call within 2e-4 of the largest of JAX's (2e-2
in bf16), the greedy tokens equal, the final state within 2e-4, every
state leaf's placement after every call equal to the ``PartitionSpec`` the
JAX side gives it (less the stacked units' axis), the mesh decode equal to
the port's one-device decode (where ``moe_ep`` drops nothing), the caches
and memories written in place, every rank holding the same logits, the
MoE layers' routing and the copies their capacity drops equal to JAX's,
the serving kernels given each rank's local block, the prompt's forward
on the mesh equal to JAX's sharded forward, and a forward at batch 1."""

import dataclasses
import inspect
import json

import numpy as np
import pytest
from torch_mesh_worlds import close, run_both

FAMILIES = ("stablelm_3b", "command_r_plus_104b", "granite_20b", "qwen2_5_32b",
            "recurrentgemma_9b", "xlstm_1_3b", "deepseek_moe_16b", "kimi_k2_1t_a32b",
            "qwen2_vl_72b")
# (tag, arch, batch, prefill, steps, dtype, n_heads or None, MoE capacity factor or None)
CASES = [(a, a, 4, 8, 4, "float32", None, None) for a in FAMILIES] + [
    ("rg_ring", "recurrentgemma_9b", 4, 12, 8, "float32", None, None),  # 12..19, window 16
    ("rg_batch1", "recurrentgemma_9b", 1, 8, 4, "float32", None, None),
    ("xlstm_batch1", "xlstm_1_3b", 1, 8, 4, "float32", None, None),
    ("xlstm_one_head", "xlstm_1_3b", 4, 8, 4, "float32", 1, None),
    ("stablelm_bf16", "stablelm_3b", 4, 8, 2, "bfloat16", None, None),
    # a capacity of every copy (2 × n·k / 2 model ranks): nothing drops
    ("deepseek_no_drop", "deepseek_moe_16b", 4, 8, 4, "float32", None, 2.0),
    ("kimi_no_drop", "kimi_k2_1t_a32b", 4, 8, 4, "float32", None, 2.0),
]
PARTS = ("0", "1", "2")
MOE_TAGS = ("deepseek_moe_16b", "kimi_k2_1t_a32b")
# moe_ep drops the copies past a rank's capacity, which the one-device
# path (ragged, exact) keeps, as in the reference; their no-drop cases are
# held to the one-device decode instead
ONE_DEVICE_TAGS = [c[0] for c in CASES if c[0] not in MOE_TAGS]


def _tol(case) -> float:
    return 2e-2 if case["dtype"] == "bfloat16" else 2e-4


def config(get_smoke, case):
    """A case's configuration from either package's ``get_smoke`` (the
    scripts run this function's source): init_scale 1, so that every layer
    moves the logits (at the default 0.02 they move them by about 1e-7 of
    their size), and the case's heads and MoE capacity factor."""
    cfg = dataclasses.replace(get_smoke(case["arch"]), init_scale=1.0)
    if case["capacity"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity"]))
    return dataclasses.replace(cfg, n_heads=case["n_heads"]) if case["n_heads"] else cfg


COMMON = r"""
import dataclasses, json, os
import numpy as np
OUT = os.environ["OUT"]
with open(os.path.join(OUT, "cases.json")) as fh:
    CASES = json.load(fh)
given = np.load(os.path.join(OUT, "given.npz"))


def sorted_stack(arrays):
    # a multiset of records as one array: the MoE layers' order on a device is not kept
    arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
    return np.stack(sorted(arrays, key=lambda a: a.tobytes()))


""" + inspect.getsource(config)

JAX_SCRIPT = COMMON + r"""
import pickle
# one thread a process: the file runs beside the suite's other workers
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed.sharding import FSDP_RULES, SP_RULES, batch_spec, tree_shardings
from repro.launch.mesh import make_host_mesh, set_mesh
from repro.models import moe as MOE
from repro.models.lm import LM, MeshContext

PART = os.environ["PART"]
RULES = {"fsdp": FSDP_RULES, "sp": SP_RULES}
with open(os.path.join(OUT, "trees.pkl"), "rb") as fh:
    trees = pickle.load(fh)
mesh = make_host_mesh(model_parallel=2)
mctx = MeshContext(mesh, ("data",), "model")
repl = NamedSharding(mesh, P())
routes = {}


def recorder(kind):
    def record(values, data, model):
        routes.setdefault((kind, int(data), int(model)), []).append(np.asarray(values))
    return record


_route, _expert_ffn = MOE._route, MOE._expert_ffn


def route(xf, router, m):  # the expert ids of this device's tokens
    out = _route(xf, router, m)
    jax.debug.callback(recorder("ids"), out[0], jax.lax.axis_index("data"),
                       jax.lax.axis_index("model"))
    return out


def expert_ffn(tokens, eids, *args, **kwargs):  # the slots this device received
    jax.debug.callback(recorder("eids"), eids, jax.lax.axis_index("data"),
                       jax.lax.axis_index("model"))
    return _expert_ffn(tokens, eids, *args, **kwargs)


MOE._route, MOE._expert_ffn = route, expert_ffn


def per_layer(model, tree, leaf_of):
    # the port's layer order: head, unit u's pattern for each u, tail;
    # leaf_of(leaf, u) takes unit u's layer out of a stacked leaf
    units = [jax.tree.map(lambda a: leaf_of(a, u), tree["units"][j])
             for u in range(model.n_units) for j in range(len(model.unit_pattern))]
    return [*tree["head"], *units, *tree["tail"]]


def spec(sharding, drop):
    entries = list(sharding.spec)[drop:]
    out = [[] if e is None else [e] if isinstance(e, str) else list(e) for e in entries]
    while out and not out[-1]:
        out.pop()
    return out


def layer_specs(model, shardings):
    # each leaf's spec, a stacked unit's without its leading axis
    specs = {"head": jax.tree.map(lambda s: spec(s, 0), shardings["head"]),
             "units": jax.tree.map(lambda s: spec(s, 1), shardings["units"]),
             "tail": jax.tree.map(lambda s: spec(s, 0), shardings["tail"])}
    return np.asarray(json.dumps(
        [list(layer) for layer in per_layer(model, specs, lambda a, u: a)]))


out = {}
for case in CASES:
    if case["part"] != PART:
        continue
    tag = case["tag"]
    cfg = config(get_smoke, case)
    dtype = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    model = LM(cfg, mctx, remat=False, dtype=dtype)
    b = case["batch"]
    with set_mesh(mesh):
        params = trees[tag]
        psh = tree_shardings(params, model.param_axes(), mesh)
        params = jax.tree.map(jax.device_put, params, psh)
        state = model.init_decode_state(b, case["prefill"] + case["steps"], dtype)
        ssh = tree_shardings(state, model.decode_state_axes(), mesh)
        state = jax.tree.map(jax.device_put, state, ssh)
        bsh = NamedSharding(mesh, batch_spec(mesh, b))
        prefill = jax.jit(lambda p, t, s: model.decode_step(p, t, s, jnp.int32(0)),
                          in_shardings=(psh, bsh, ssh), out_shardings=(bsh, ssh))
        step = jax.jit(lambda p, t, s, pos: model.decode_step(p, t, s, pos),
                       in_shardings=(psh, bsh, ssh, repl), out_shardings=(bsh, ssh))
        tokens, pos = given[f"{tag}/prompt"], 0
        for i in range(case["steps"] + 1):
            routes.clear()
            toks = jax.device_put(jnp.asarray(tokens), bsh)
            if i == 0:
                logits, state = prefill(params, toks, state)
            else:
                logits, state = step(params, toks, state, jax.device_put(jnp.int32(pos), repl))
            jax.effects_barrier()
            pos += tokens.shape[1]
            logits = np.asarray(logits.astype(jnp.float32))
            out[f"{tag}/logits/{i}"] = logits
            tokens = logits[:, -1].argmax(-1)[:, None] if case["greedy"] \
                else given[f"{tag}/next"][:, i : i + 1]
            out[f"{tag}/tokens/{i}"] = tokens
            for (kind, data, mdl), records in routes.items():
                out[f"{tag}/route/{i}/{kind}/{data}{mdl}"] = sorted_stack(records)
        if case["forward"]:  # the prompt's full forward, as the dry run's prefill of a
            # non-causal cell jits it
            fwd = jax.jit(lambda p, t: model.forward(p, {"tokens": t})[0],
                          in_shardings=(psh, bsh), out_shardings=bsh)
            out[f"{tag}/forward"] = np.asarray(fwd(params, jax.device_put(
                jnp.asarray(given[f"{tag}/prompt"]), bsh)))
        out[f"{tag}/specs"] = layer_specs(model, jax.tree.map(lambda a: a.sharding, state))
        fresh = jax.eval_shape(lambda: model.init_decode_state(
            b, case["prefill"] + case["steps"], dtype))
        for name, rules in RULES.items():  # where the dry run's other plans put it
            out[f"{tag}/specs/{name}"] = layer_specs(model, tree_shardings(
                fresh, model.decode_state_axes(), mesh, rules))
        for i, layer in enumerate(per_layer(model, state, lambda a, u: a[u])):
            for j, leaf in enumerate(layer):
                out[f"{tag}/state/{i}/{j}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(os.path.join(OUT, f"jax_{PART}.npz"), **out)
"""

RANK_SCRIPT = COMMON + r"""
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import FSDP_RULES, SP_RULES, data_axis_names
from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
from repro_torch.models import attention as A, moe as MOE, rglru as RG, xlstm as XL
from repro_torch.models.lm import LM, MeshContext
from repro_torch.runtime.train_loop import functional_decode

mesh = make_host_mesh(2, device="cpu")
rank = dist.get_rank()
coord = "".join(str(c) for c in mesh.get_coordinate())
mctx = MeshContext(mesh, data_axis_names(mesh), "model")
out = {"coord": np.asarray(mesh.get_coordinate())}
seen, routes = {}, {}


def spy(module, name, state_arg):
    # the shapes of the wrapper's first argument and of its cache or state
    # argument as the kernel sees them: plain local tensors
    op = getattr(module, name)

    def wrapped(*args, **kwargs):
        shapes = [list(args[i].shape) if type(args[i]) is torch.Tensor else [-1]
                  for i in (0, state_arg)]
        seen.setdefault(name, []).append(shapes)
        return op(*args, **kwargs)

    setattr(module, name, wrapped)


spy(A, "flash_attention_op", 1)
spy(RG, "rg_lru_op", 2)
spy(XL, "mlstm_chunk_op", 5)
_route, _expert_ffn = MOE._route, MOE._expert_ffn


def route(xf, router, m):
    out_ = _route(xf, router, m)
    routes.setdefault("ids", []).append(out_[0].numpy())
    return out_


def expert_ffn(tokens, eids, *args, **kwargs):
    routes.setdefault("eids", []).append(eids.numpy())
    return _expert_ffn(tokens, eids, *args, **kwargs)


MOE._route, MOE._expert_ffn = route, expert_ffn


def spec(t):
    # a DTensor's placements as the PartitionSpec's entries
    entries = [[] for _ in range(t.ndim)]
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
    while entries and not entries[-1]:
        entries.pop()
    return entries


def shards(t):
    # the blocks a DTensor is cut into
    return int(np.prod([n for n, pl in zip(mesh.shape, t.placements) if pl.is_shard()]))


def model_of(case, mctx):
    dtype = getattr(torch, case["dtype"])
    model = LM(config(get_smoke, case), "cpu", mctx=mctx, dtype=dtype, remat=False)
    tag = case["tag"]
    model.load_state_dict({k[len(tag) + 8:].replace("/", "."): torch.from_numpy(given[k])
                           for k in given.files if k.startswith(f"{tag}/params/")})
    return model


def decode(case, model, run, plain=False):
    # a prefill and the steps -> the logits of every call (and the specs)
    tag = case["tag"]
    state = model.init_decode_state(case["batch"], case["prefill"] + case["steps"])
    tokens, pos, logits_all, specs = torch.from_numpy(given[f"{tag}/prompt"]), 0, [], []
    in_place = True
    for i in range(case["steps"] + 1):
        routes.clear()
        before = written(model, state, plain)
        logits, state = run(tokens, state, pos)
        in_place &= written(model, state, plain) == before
        pos += tokens.shape[1]
        full = (logits if plain else logits.full_tensor()).float()
        logits_all.append(full.numpy())
        tokens = full[:, -1].argmax(-1, keepdim=True) if case["greedy"] \
            else torch.from_numpy(given[f"{tag}/next"][:, i : i + 1])
        if not plain:
            out[f"{tag}/tokens/{i}"] = tokens.numpy()
            specs.append([[spec(t) for t in layer] for layer in state])
            for kind, records in routes.items():
                out[f"{tag}/route/{i}/{kind}/{coord}"] = sorted_stack(records)
            out[f"{tag}/logits_placements/{i}"] = np.asarray(
                [f"S{pl.dim}" if pl.is_shard() else "R" for pl in logits.placements])
    out[f"{tag}/in_place{'/one' if plain else ''}"] = np.asarray(in_place)
    return logits_all, specs, state


def written(model, state, plain):
    # the storage of what a step writes in place: the KV caches, the mLSTM's C
    leaves = [t for kind, layer in zip(model.kinds, state)
              for t in (layer if kind == "attn" else layer[:1] if kind == "mlstm" else ())]
    return [(t if plain else t.to_local()).data_ptr() for t in leaves]


for case in CASES:
    tag = case["tag"]
    model = model_of(case, mctx)
    params = model.distribute_params({k.replace(".", "/"): p.detach()
                                      for k, p in model.named_parameters()})
    seen.clear()
    run = functional_decode(model)
    logits_all, specs, state = decode(case, model, lambda t, s, p: run(params, t, s, p))
    for i, logits in enumerate(logits_all):
        out[f"{tag}/logits/{i}"] = logits
    out[f"{tag}/specs"] = np.asarray(json.dumps(specs))
    for i, layer in enumerate(state):
        for j, leaf in enumerate(layer):
            out[f"{tag}/state/{i}/{j}"] = leaf.full_tensor().float().numpy()
            out[f"{tag}/local/{i}/{j}"] = np.asarray(leaf.to_local().shape)
    for name, shapes in seen.items():
        out[f"{tag}/{name}"] = np.asarray(json.dumps(shapes))
    # a fresh state: the one-device state's value, each rank allocating
    # only its block; and where the dry run's other plans' rules put it
    b, n = case["batch"], case["prefill"] + case["steps"]
    fresh = model.init_decode_state(b, n)
    whole = LM(config(get_smoke, case), "cpu", dtype=model.dtype).init_decode_state(b, n)
    out[f"{tag}/fresh_is_one_device"] = np.asarray(all(
        torch.equal(t.full_tensor(), w) for layer, one in zip(fresh, whole)
        for t, w in zip(layer, one)))
    out[f"{tag}/fresh_holds_its_block"] = np.asarray(all(
        t.to_local().untyped_storage().nbytes()
        == t.numel() * t.element_size() // shards(t) for layer in fresh for t in layer))
    for name, rules in (("fsdp", FSDP_RULES), ("sp", SP_RULES)):
        out[f"{tag}/specs/{name}"] = np.asarray(json.dumps(
            [[spec(t) for t in layer] for layer in model.init_decode_state(b, n, rules=rules)]))
    if case["forward"]:
        logits = torch.func.functional_call(
            model, {k.replace("/", "."): v for k, v in params.items()},
            ({"tokens": torch.from_numpy(given[f"{tag}/prompt"])},))
        out[f"{tag}/forward"] = logits.full_tensor().numpy()
    if tag == "rg_ring":  # a block into the ring past position 0 still raises
        try:
            run(params, torch.zeros((4, 2), dtype=torch.int64), state,
                case["prefill"] + case["steps"])
        except NotImplementedError as e:
            out["ring_block_raises"] = np.asarray(str(e))

# a forward at a batch that does not divide the data axes (ROADMAP Queue 3,
# PR 34): the sLSTM's unbind once met the sequence split over them
for arch in ("xlstm_1_3b", "recurrentgemma_9b"):
    case = next(c for c in CASES if c["arch"] == arch and c["batch"] == 1)
    model = model_of(case, mctx)
    params = model.distribute_params({k.replace(".", "/"): p.detach()
                                      for k, p in model.named_parameters()})
    tokens = {"tokens": torch.from_numpy(given[f"{case['tag']}/prompt"])}
    want = model_of(case, None)(tokens)
    got = torch.func.functional_call(
        model, {k.replace("/", "."): v for k, v in params.items()}, (tokens,))
    out[f"forward_batch1/{arch}"] = got.full_tensor().numpy()
    out[f"forward_batch1/{arch}/one"] = want.numpy()

for k, case in enumerate(CASES):  # each rank decodes its share off the mesh
    if k % dist.get_world_size() == rank:
        model = model_of(case, None)
        logits_all, _, _ = decode(case, model, model.decode_step, plain=True)
        for i, logits in enumerate(logits_all):
            out[f"{case['tag']}/one/{i}"] = logits
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
destroy_process_group()
"""


def _cases() -> list[dict]:
    keys = ("tag", "arch", "batch", "prefill", "steps", "dtype", "n_heads", "capacity")
    return [dict(zip(keys, c), greedy=c[5] == "float32", forward=c[0] in FAMILIES,
                 part=PARTS[i % len(PARTS)]) for i, c in enumerate(CASES)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's seeded parameters (seed 0) for both sides, the prompts
    (and the bf16 case's tokens) from numpy, then both sides at once."""
    import pickle

    import ml_dtypes  # noqa: F401  numpy's bfloat16, for the bf16 case's tree
    import torch

    from repro_torch.bridge import lm_params_to_jax
    from repro_torch.configs import ARCH_IDS, get_smoke
    from repro_torch.models.lm import LM

    assert set(FAMILIES) == {a for a in ARCH_IDS if get_smoke(a).causal}
    cases = _cases()
    given, trees = {}, {}
    for k, case in enumerate(cases):
        cfg = config(get_smoke, case)
        model = LM(cfg, "cpu", dtype=getattr(torch, case["dtype"]), seed=0)
        trees[case["tag"]] = lm_params_to_jax(model)
        for name, p in model.named_parameters():
            given[f"{case['tag']}/params/{name.replace('.', '/')}"] = p.detach().float().numpy()
        rng = np.random.default_rng(k + 1)
        given[f"{case['tag']}/prompt"] = rng.integers(
            4, cfg.vocab_size, (case["batch"], case["prefill"]))
        given[f"{case['tag']}/next"] = rng.integers(
            4, cfg.vocab_size, (case["batch"], case["steps"]))
    out = tmp_path_factory.mktemp("mesh_decode")
    np.savez(out / "given.npz", **given)
    with open(out / "trees.pkl", "wb") as fh:
        pickle.dump(trees, fh)
    with open(out / "cases.json", "w") as fh:
        json.dump(cases, fh)
    ref, ranks = run_both(JAX_SCRIPT, RANK_SCRIPT, out, PARTS, timeout=300, serial=True)
    return {c["tag"]: c for c in cases}, ref, ranks


TAGS = [c[0] for c in CASES]


@pytest.mark.parametrize("tag", TAGS)
def test_mesh_decode_is_the_references(worlds, tag):
    """Every call's logits, the greedy tokens and the final state against
    JAX's jitted sharded decode step; every rank holds the same logits."""
    cases, ref, ranks = worlds
    case = cases[tag]
    tol = _tol(case)
    for i in range(case["steps"] + 1):
        got = ranks[0][f"{tag}/logits/{i}"]
        assert got.shape == (case["batch"], 1, 64)
        close(got, ref[f"{tag}/logits/{i}"], err_msg=f"call {i}", tol=tol)
        np.testing.assert_array_equal(ranks[0][f"{tag}/tokens/{i}"], ref[f"{tag}/tokens/{i}"])
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[f"{tag}/logits/{i}"], got)
    leaves = [k for k in ref if k.startswith(f"{tag}/state/")]
    assert leaves and len(leaves) == len([k for k in ranks[0] if k.startswith(f"{tag}/state/")])
    for k in leaves:
        close(ranks[0][k], ref[k], err_msg=k, tol=tol)


@pytest.mark.parametrize("tag", FAMILIES)
def test_the_prompts_forward_on_the_mesh_is_the_references(worlds, tag):
    """The full forward over the prompt at ``init_scale`` 1 (PR 32's path,
    where every layer moves the logits) against JAX's jitted sharded
    forward."""
    _, ref, ranks = worlds
    for got in ranks:
        close(got[f"{tag}/forward"], ref[f"{tag}/forward"])


@pytest.mark.parametrize("tag", TAGS)
def test_the_state_stays_where_the_references_rules_put_it(worlds, tag):
    """Every leaf's placement after every call is the ``PartitionSpec`` of
    JAX's state for that leaf, the stacked units' axis left out; the logits
    come out placed by the batch's spec."""
    cases, ref, ranks = worlds
    case = cases[tag]
    want = json.loads(str(ref[f"{tag}/specs"]))
    for got in ranks:
        specs = json.loads(str(got[f"{tag}/specs"]))
        assert len(specs) == case["steps"] + 1
        for call in specs:
            assert call == want
        rows = "S0" if case["batch"] % 2 == 0 else "R"
        for i in range(case["steps"] + 1):
            assert list(got[f"{tag}/logits_placements/{i}"]) == [rows, "R"]


@pytest.mark.parametrize("tag", TAGS)
def test_a_fresh_state_is_allocated_block_by_block(worlds, tag):
    """``init_decode_state`` on the mesh holds the one-device state's
    value, while each rank allocates only its own block of every leaf."""
    _, _, ranks = worlds
    for got in ranks:
        assert bool(got[f"{tag}/fresh_is_one_device"])
        assert bool(got[f"{tag}/fresh_holds_its_block"])


@pytest.mark.parametrize("rules", ["fsdp", "sp"])
def test_the_state_takes_the_rules_it_is_given(worlds, rules):
    """Under the dry run's other plans' rules (``FSDP_RULES``, and
    ``SP_RULES``, whose cache lies over the model axis by its sequence) a
    fresh state's placements are JAX's ``tree_shardings`` of its state."""
    _, ref, ranks = worlds
    for tag in TAGS:
        want = json.loads(str(ref[f"{tag}/specs/{rules}"]))
        for got in ranks:
            assert json.loads(str(got[f"{tag}/specs/{rules}"])) == want, tag


@pytest.mark.parametrize("tag", TAGS)
def test_the_caches_and_memories_are_written_in_place(worlds, tag):
    """Every call writes the KV caches and the mLSTM memories C into the
    storage they had (each rank's block of them on the mesh), as off it;
    where the rules put C's ``rnn`` over the model axis, the gathered C
    the kernel wrote goes back into the stored block."""
    _, _, ranks = worlds
    for got in ranks:
        assert bool(got[f"{tag}/in_place"])
    assert any(bool(r[f"{tag}/in_place/one"]) for r in ranks if f"{tag}/in_place/one" in r)


@pytest.mark.parametrize("tag", ONE_DEVICE_TAGS)
def test_mesh_decode_is_the_one_device_decode(worlds, tag):
    cases, _, ranks = worlds
    case = cases[tag]
    for i in range(case["steps"] + 1):
        one = next(r[f"{tag}/one/{i}"] for r in ranks if f"{tag}/one/{i}" in r)
        close(ranks[0][f"{tag}/logits/{i}"], one, err_msg=f"call {i}", tol=_tol(case))


def _drops(ids: np.ndarray, n_experts: int, n_shards: int, capacity_factor: float) -> int:
    """The token copies one data shard's capacity drops, by the rule of
    ``repro/models/moe.py:167 _moe_ep_body``."""
    n, k = ids.shape
    owner = ids.reshape(-1) // (n_experts // n_shards)
    cap = int(np.ceil(n * k / n_shards * capacity_factor))
    counts = np.bincount(owner, minlength=n_shards)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("tag", MOE_TAGS)
def test_moe_routes_and_drops_as_the_reference(worlds, tag):
    """On every rank and call, the MoE layers' expert ids for this rank's
    tokens and the expert ids of the slots it received after the capacity
    drop (a dropped or empty slot carries the trash id) equal what JAX's
    sharded step routes on the same device."""
    from repro_torch.configs import get_smoke

    cases, ref, ranks = worlds
    m = get_smoke(cases[tag]["arch"]).moe
    dropped = 0
    for got in ranks:
        coord = "".join(str(c) for c in got["coord"])
        for i in range(cases[tag]["steps"] + 1):
            for kind in ("ids", "eids"):
                key = f"{tag}/route/{i}/{kind}/{coord}"
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            ids = got[f"{tag}/route/{i}/ids/{coord}"]
            assert len(ids) == 2  # two MoE layers
            dropped += sum(_drops(layer, m.n_experts, 2, m.capacity_factor) for layer in ids)
    # the seeded routing overflows some one-token steps' capacity (2 tokens
    # a data shard), so the rule that drops copies is held too
    assert dropped > 0


@pytest.mark.parametrize("tag, op, prefill, step, state", [
    # rows / 2 and 4 heads / 2; the prefill reads the cache, as a step does
    ("stablelm_3b", "flash_attention_op", [2, 8, 2, 16], [2, 1, 2, 16],
     ([2, 12, 2, 16], [2, 12, 2, 16])),
    # 1 kv head: head_dim lies over the model axis, the kernel gets whole
    # heads of the positions it reads, the first 8 + i of 12 at call i
    ("granite_20b", "flash_attention_op", [2, 8, 8, 8], [2, 1, 8, 8],
     ([2, 8, 1, 8], lambda i: [2, 8 + i, 1, 8])),
    # a ring of 12 slots: the prefill attends within the block; 1 kv head,
    # so the steps gather the slots they read, as Granite's
    ("recurrentgemma_9b", "flash_attention_op", [2, 8, 4, 16], [2, 1, 4, 16],
     ([2, 8, 1, 16], lambda i: [2, 8 + i, 1, 16])),
    ("recurrentgemma_9b", "rg_lru_op", [2, 8, 32], [2, 1, 32], ([2, 32], [2, 32])),
    ("xlstm_1_3b", "mlstm_chunk_op", [2, 8, 2, 16], [2, 1, 2, 16],
     ([2, 2, 16, 16], [2, 2, 16, 16])),  # 4 heads / 2
    # one head: rnn lies over the model axis, the kernel gets the whole state
    ("xlstm_one_head", "mlstm_chunk_op", [2, 8, 1, 64], [2, 1, 1, 64],
     ([2, 1, 64, 64], [2, 1, 64, 64])),
])
def test_the_serving_kernels_run_on_local_shards(worlds, tag, op, prefill, step, state):
    """Each kernel wrapper got plain local tensors, this rank's rows and
    heads or channels, once a layer of its kind and call: the first
    argument's shape and the cache's or state's, in the prefill and in
    the steps (the step's state shape may depend on the call)."""
    cases, _, ranks = worlds
    calls = cases[tag]["steps"] + 1
    at = state[1] if callable(state[1]) else lambda i: state[1]
    for got in ranks:
        shapes = json.loads(str(got[f"{tag}/{op}"]))
        layers = len(shapes) // calls
        assert layers > 0 and len(shapes) == layers * calls, shapes
        assert shapes[:layers] == [[prefill, state[0]]] * layers, shapes
        assert shapes[layers:] == [[step, at(i)] for i in range(1, calls)
                                   for _ in range(layers)], shapes


def test_the_stored_cache_keeps_its_head_dim_placement(worlds):
    """Granite-20B's one kv head does not divide the model axis, so the
    cache's head_dim lies over it: each rank stores half of every head,
    while the kernel read the whole of the positions it reads (the test
    above)."""
    _, _, ranks = worlds
    for got in ranks:
        for layer in range(3):
            for leaf in (0, 1):
                assert list(got[f"granite_20b/local/{layer}/{leaf}"]) == [2, 12, 1, 4]


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "recurrentgemma_9b"])
def test_a_forward_at_batch_one_on_the_mesh(worlds, arch):
    """A batch of one does not divide the data axes: its rows are
    replicated over them, and the forward is the one-device forward (the
    sLSTM raised on it before, ROADMAP Queue 3)."""
    _, _, ranks = worlds
    for got in ranks:
        close(got[f"forward_batch1/{arch}"], got[f"forward_batch1/{arch}/one"])


def test_a_ring_block_past_position_zero_still_raises(worlds):
    _, _, ranks = worlds
    for got in ranks:
        assert "ring KV cache at position 20" in str(got["ring_block_raises"])
